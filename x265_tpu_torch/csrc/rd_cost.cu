// The RD passes' transform-block cost chain in one launch: for a batch of N
// same-size TBs (S = 8, 16 or 32) the residual src - pred, the forward integer
// DCT, the deadzone quant, the static-rate RDOQ, sign-bit hiding, cbf, the
// dequant and the inverse DCT with its 16-bit clamps, reduced to the four
// integers the RD passes keep of a TB: the SSE of the reconstruction error, the
// Q15 estBit rate with its coded_sub_block_flag structure, the psy energy
// difference (sa8d minus DC of each 8x8 tile, source against reconstruction)
// and cbf. The levels and the reconstruction never leave the chip.
//
// Replaces no TPU kernel. The JAX package leaves this chain to XLA inside
// models/rdo.py (_promo_costs, _adopt_costs) and models/intra_rdo.py
// (_intra32_costs); the port ran it as some 120 PyTorch launches a TB size
// without RDOQ and 470 with it (ops.cuda_kernels.rd_tb_cost_plain composes
// the same chain from models/residual._tq_chain and stays its oracle). The
// arithmetic is the chain's, operation for operation, in the chain's integer
// widths: int32 for the transforms, the quant and the flat dequant, int64 for
// RDOQ's costs and the scaling-list dequant.
//
// Rounding points that stay outside, in PyTorch (models/rdo._tb_costs), in
// the order the reference's float32 code takes them: each TB's int64 -> float32
// conversion; the rate's * (1/32768) + last-position estimate; the where(cbf,
// rate, 0); the float32 sums over a 64x64 region's four quads and over the
// three planes; the three-term cost (_rd_cost, one fused multiply-add). A
// float32 sum depends on its order, so it is not taken here.
//
// Layout: src, pred int32 [N, S, S]; qp int32 [N] (the plane's Qp'); rk int32
// [8] (hevc/rate_model.py's consts row of the plane); tab int32: the DCT
// matrix [S, S], the scaling matrix [S, S] (16 everywhere without scaling
// lists), the six quant and the six dequant scales; lam int64 [70], the static
// RDOQ lambda table; out int64 [N, 4]: sse, rate (Q15), psy, cbf.
//
// Design. The work is small: a 1080p rd_promote32 pass is some 30,000 TBs and
// under a billion integer multiply-adds. Its bound is the bytes (8 a sample
// in, 32 a TB out) at 8x8 and the four transform passes' multiply-adds at
// 16x16 and 32x32, a few microseconds either way; at the sizes the encoder
// calls it, the launch itself costs more, so what the kernel buys is the
// hundred-odd PyTorch launches a call it removes. A CTA holds
// 1024 coefficients: one 32x32 TB, four 16x16 or sixteen 8x8, 256 threads of
// four slots each. The two transform passes of each direction run through
// shared memory, the matrix in both orientations there so that a warp reads
// consecutive words (a warp-divergent index into constant memory serialises).
// The per-coefficient phases (quant, RDOQ, SBH, rate) number slots CG by CG:
// a 4x4 coefficient group is 16 adjacent lanes, so RDOQ's CG zeroing and SBH
// reduce by shuffles, and the 32 lanes of a warp are a half 8x8 tile for the
// psy energy. Per-TB sums are reduced in a fixed order in the CTA (shuffles,
// then one thread a TB over the partials), with no atomics.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 1024;                  // coefficients a CTA holds
constexpr int kIters = kSlots / kThreads;     // slots a thread
constexpr int kWarps = kThreads / 32;
constexpr int kParts = kSlots / 32;           // warp partials a CTA
constexpr unsigned kAll = 0xffffffffu;
// a 4x4 CG's up-right diagonal scan: position r*4+c -> scan index, a nibble
// each (hevc.tables.SCANS; the same within every CG of an 8x8..32x32 TB)
constexpr unsigned long long kDiag4 = 0xfda6eb73c8419520ull;

__device__ __forceinline__ long long sum16(long long v) {
  v += __shfl_xor_sync(kAll, v, 8);
  v += __shfl_xor_sync(kAll, v, 4);
  v += __shfl_xor_sync(kAll, v, 2);
  return v + __shfl_xor_sync(kAll, v, 1);
}

__device__ __forceinline__ long long sum32(long long v) {
  v = sum16(v);
  return v + __shfl_xor_sync(kAll, v, 16);
}

__device__ __forceinline__ int min16(int v) {
  for (int m = 8; m; m >>= 1) v = min(v, __shfl_xor_sync(kAll, v, m));
  return v;
}

__device__ __forceinline__ int max16(int v) {
  for (int m = 8; m; m >>= 1) v = max(v, __shfl_xor_sync(kAll, v, m));
  return v;
}

__device__ __forceinline__ int rshift_round(int x, int s) {
  return (x + (1 << (s - 1))) >> s;
}

__device__ __forceinline__ int clamp16(long long x) {
  return (int)max(-32768ll, min(32767ll, x));
}

// +-1 of the Sylvester 8x8 Hadamard matrix (any row order gives sa8d)
__device__ __forceinline__ int had(int a, int b) {
  return (__popc(a & b) & 1) ? -1 : 1;
}

// hevc/rate_model.rate_fx_t: Q15 rate of one |level|
__device__ __forceinline__ int rate_fx(int l, const int* k) {
  if (l == 0) return k[0];
  const int base = k[1] + 32768;
  if (l == 1) return base + k[2];
  if (l == 2) return base + k[3] + k[4];
  int rem;
  if (l < 6) {
    rem = (l - 2) << 15;
  } else {
    const int esc = min(l - 5, 1 << 16);
    rem = (4 + 2 * min(31 - __clz(esc), 15)) << 15;
  }
  return base + k[3] + k[5] + rem;
}

__device__ __forceinline__ int floor_div6(int q) {
  return q >= 0 ? q / 6 : -((5 - q) / 6);
}

// models/residual._deq_core for one level: the flat path in int32 (scale
// dq * 16), the scaling-list path in int64 (scale dq * m); `rounded` adds
// the normative rounding on a right shift (RDOQ's candidates have none)
__device__ __forceinline__ long long deq(int l, int dq, int m, int sh,
                                         bool scaling, bool rounded) {
  if (!scaling) {
    const int t = l * (dq * 16);
    if (sh >= 0) return (long long)(t << sh);
    return (long long)((t + (rounded ? 1 << (-sh - 1) : 0)) >> -sh);
  }
  const long long t = (long long)l * ((long long)dq * m);
  if (sh >= 0) return t << sh;
  return (t + (rounded ? 1ll << (-sh - 1) : 0ll)) >> -sh;
}

template <int S, bool kRdoq>
__global__ void __launch_bounds__(kThreads)
rd_tb_cost_kernel(const int32_t* __restrict__ src,
                  const int32_t* __restrict__ pred,
                  const int32_t* __restrict__ qp,
                  const int32_t* __restrict__ rk,
                  const int32_t* __restrict__ tab,
                  const long long* __restrict__ lam_tab,
                  long long* __restrict__ out, int n, int is_intra, int bd,
                  int sdh, int scaling, int want_psy) {
  constexpr int SS = S * S, TBS = kSlots / SS, NCG = S / 4;
  constexpr int LOG2 = S == 8 ? 3 : (S == 16 ? 4 : 5);
  constexpr int PARTS_TB = SS / 32;
  __shared__ int sT[SS], sTt[SS], sM[SS];
  // raster [TBS][S][S]: sR the residual (later the source), sU and sV the
  // transforms' intermediates, sC the coefficients, then the levels, then
  // the reconstruction
  __shared__ int sR[kSlots], sU[kSlots], sV[kSlots], sC[kSlots];
  __shared__ int sQuant[6], sDeq[6], sRk[8], sQp[TBS], sLast[TBS];
  __shared__ int sCgNz[kSlots / 16];
  __shared__ long long sCgRate[kSlots / 16];
  __shared__ long long sPart[5][kParts];   // sse; |had| and sum, src / rec

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tb0 = blockIdx.x * TBS;
  const int ntb = min(TBS, n - tb0);
  const int nel = ntb * SS;
  const long long g0 = (long long)tb0 * SS;
  const int maxv = (1 << bd) - 1;

  for (int i = tid; i < SS; i += kThreads) {
    const int v = tab[i];
    sT[i] = v;
    sTt[(i % S) * S + i / S] = v;
    sM[i] = tab[SS + i];
  }
  if (tid < 6) {
    sQuant[tid] = tab[2 * SS + tid];
    sDeq[tid] = tab[2 * SS + 6 + tid];
  }
  if (tid < 8) sRk[tid] = rk[tid];
  if (tid < TBS) sQp[tid] = tid < ntb ? qp[tb0 + tid] : 0;
  for (int e = tid; e < kSlots; e += kThreads)
    sR[e] = e < nel ? src[g0 + e] - pred[g0 + e] : 0;
  __syncthreads();

  // ---- forward transform (models/residual.fwd_transform_b)
  const int s1 = LOG2 + bd - 9;
  for (int e = tid; e < kSlots; e += kThreads) {
    const int* row = sR + (e / S) * S;   // residual row y
    const int k = e % S;
    int acc = 0;
#pragma unroll 8
    for (int x = 0; x < S; ++x) acc += row[x] * sTt[x * S + k];
    sU[e] = rshift_round(acc, s1);       // [y][k]: the first pass's [k][y]
  }
  __syncthreads();
  for (int e = tid; e < kSlots; e += kThreads) {
    const int* blk = sU + (e / SS) * SS;
    const int a = (e % SS) / S, k = e % S;
    int acc = 0;
#pragma unroll 8
    for (int y = 0; y < S; ++y) acc += sT[a * S + y] * blk[y * S + k];
    sC[e] = rshift_round(acc, LOG2 + 6);
  }
  __syncthreads();

  // ---- quant, RDOQ, SBH, the rate's CG sums: a slot a coefficient, CG by
  // CG (slot = tb * SS + cg * 16 + w, cg in raster order of the TB's CGs)
  const int tr_shift = 15 - bd - LOG2;
  const int bs = bd + LOG2 - 5;
  for (int it = 0; it < kIters; ++it) {
    const int slot = tid + it * kThreads;
    const int tb = slot / SS, j = slot % SS;
    const int cg = j >> 4, w = j & 15;
    const int p = ((cg / NCG) * 4 + (w >> 2)) * S + (cg % NCG) * 4 + (w & 3);
    const int e = tb * SS + p;
    const int c = sC[e];
    const int q = sQp[tb];
    const int per = floor_div6(q), rem = q - 6 * per;
    const int qbits = 14 + per + tr_shift;
    int scale = sQuant[rem];
    if (scaling) scale = scale * 16 / sM[p];
    const int offset = (is_intra ? 171 : 85) << (qbits - 9);
    const int v = min((abs(c) * scale + offset) >> qbits, 32767);
    int lv = c < 0 ? -v : v;

    if (kRdoq) {
      // models/residual._rdoq_x64, the static bin-count branch (consts
      // None, psy_fx 0): three candidates a coefficient, the first of equal
      // costs kept, then the CG zeroing
      const long long lam = lam_tab[q] << (2 * tr_shift);
      const int dq = sDeq[rem], m = sM[p], sh = per - bs;
      const long long c64 = c;
      const int sgn = (lv > 0) - (lv < 0), l0 = abs(lv);
      auto rcost = [&](int l) -> long long {
        // l <= 32767: the chain's 15-step ilog2 equals floor(log2(l))
        const int lg = 31 - __clz(max(l, 1));
        return lam * ((l > 0 ? 3 : 1) + (l > 1 ? 2 + 2 * lg : 0));
      };
      auto err = [&](int l) -> long long {
        return c64 - sgn * deq(l, dq, m, sh, scaling, false);
      };
      auto cost = [&](int l) -> long long {
        const long long d = err(l);
        return 32 * d * d + rcost(l);
      };
      int bl = l0;
      long long best = cost(l0);
      const int l1 = max(l0 - 1, 0);
      long long cc = cost(l1);
      if (cc < best) { best = cc; bl = l1; }
      cc = cost(0);
      if (cc < best) { best = cc; bl = 0; }
      const long long en = err(bl);
      const long long d_zero = sum16(c64 * c64), d_now = sum16(en * en);
      const long long r_now = sum16(rcost(bl)), any = sum16(bl);
      lv = (any > 0 && 32 * (d_zero - d_now) < r_now - lam) ? 0 : sgn * bl;
    }

    if (sdh) {
      // models/residual.sbh_b on the diagonal scan: a CG is 16 scan
      // positions; the first coded level carries the parity
      const int s = (int)((kDiag4 >> (4 * w)) & 15);
      const bool nz = lv != 0;
      const int first = min16(nz ? s : 16), last = max16(nz ? s : -1);
      const int asum = (int)sum16(abs(lv));
      if (nz && s == first && last - first > 3 &&
          (asum & 1) != (lv < 0 ? 1 : 0)) {
        const int sg = lv > 0 ? 1 : -1;
        lv = abs(lv) == 1 ? lv + sg : lv - sg;
      }
    }

    sC[e] = lv;
    const long long cg_rate = sum16(rate_fx(abs(lv), sRk));
    const int cg_nz = max16(lv != 0 ? 1 : 0);
    if (w == 0) {
      sCgRate[slot >> 4] = cg_rate;
      sCgNz[slot >> 4] = cg_nz;
    }
  }
  __syncthreads();

  // ---- the rate (models/rdo._tb_rate_fx): coded CGs pay csbf(1) and their
  // coefficients, uncoded ones before the last coded CG (raster) csbf(0)
  if (tid < TBS) {
    constexpr int NC = NCG * NCG;
    const int base = tid * NC;
    int last = -1;
    for (int g = 0; g < NC; ++g)
      if (sCgNz[base + g]) last = g;
    sLast[tid] = last;
    long long fx = 0;
    for (int g = 0; g < NC; ++g)
      fx += sCgNz[base + g] ? sRk[7] + sCgRate[base + g]
                            : (g <= last ? sRk[6] : 0);
    sCgRate[base] = fx;     // the TB's rate, read at the end
  }
  // ---- dequant (models/residual.dequantize_b), clamped to 16 bits
  for (int e = tid; e < kSlots; e += kThreads) {
    const int tb = e / SS, p = e % SS;
    const int q = sQp[tb];
    const int per = floor_div6(q), rem = q - 6 * per;
    sV[e] = clamp16(deq(sC[e], sDeq[rem], sM[p], per - bs, scaling, true));
  }
  __syncthreads();

  // ---- inverse transform (models/residual.inv_transform_b)
  for (int e = tid; e < kSlots; e += kThreads) {
    const int* blk = sV + (e / SS) * SS;
    const int y = (e % SS) / S, kx = e % S;
    int acc = 0;
#pragma unroll 8
    for (int ky = 0; ky < S; ++ky) acc += sTt[y * S + ky] * blk[ky * S + kx];
    sU[e] = clamp16(rshift_round(acc, 7));
  }
  __syncthreads();
  const int s2i = 20 - bd;
  for (int it = 0; it < kIters; ++it) {
    const int e = tid + it * kThreads;
    const int* row = sU + (e / S) * S;
    const int x = e % S;
    int acc = 0;
#pragma unroll 8
    for (int kx = 0; kx < S; ++kx) acc += row[kx] * sT[kx * S + x];
    const int rres =
        sLast[e / SS] >= 0 ? clamp16(rshift_round(acc, s2i)) : 0;
    const long long d = sR[e] - rres;
    const long long sse = sum32(d * d);
    if (lane == 0) sPart[0][it * kWarps + warp] = sse;
    if (want_psy) {
      // the source and the clamped reconstruction, for the psy energy
      const int pr = e < nel ? pred[g0 + e] : 0;
      sR[e] = e < nel ? src[g0 + e] : 0;
      sC[e] = max(0, min(maxv, pr + rres));
    }
  }

  if (want_psy) {
    // ---- psy energy (models/rdo._psy_energy8): the 8x8 Hadamard of each
    // tile of the source and of the reconstruction, rows then columns
    __syncthreads();
    for (int e = tid; e < kSlots; e += kThreads) {
      const int x0 = e & ~7, xa = e & 7;
      int us = 0, ur = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int h = had(xa, i);
        us += h * sR[x0 + i];
        ur += h * sC[x0 + i];
      }
      sU[e] = us;
      sV[e] = ur;
    }
    __syncthreads();
    // slots CG by CG again: a warp's 32 slots are two CGs side by side,
    // the top or bottom half of one 8x8 tile
    for (int it = 0; it < kIters; ++it) {
      const int slot = tid + it * kThreads;
      const int tb = slot / SS, j = slot % SS;
      const int cg = j >> 4, w = j & 15;
      const int y = (cg / NCG) * 4 + (w >> 2), x = (cg % NCG) * 4 + (w & 3);
      const int col = tb * SS + (y & ~7) * S + x, ya = y & 7;
      int vs = 0, vr = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int h = had(ya, i);
        vs += h * sU[col + i * S];
        vr += h * sV[col + i * S];
      }
      const int e = tb * SS + y * S + x;
      const long long hs = sum32(abs(vs)), ds = sum32(sR[e]);
      const long long hr = sum32(abs(vr)), dr = sum32(sC[e]);
      if (lane == 0) {
        const int pi = it * kWarps + warp;
        sPart[1][pi] = hs;
        sPart[2][pi] = ds;
        sPart[3][pi] = hr;
        sPart[4][pi] = dr;
      }
    }
  }
  __syncthreads();

  // ---- one thread a TB: its partials in a fixed order
  if (tid < ntb) {
    long long sse = 0, psy = 0;
    const int q0 = tid * PARTS_TB;
    for (int q = q0; q < q0 + PARTS_TB; ++q) sse += sPart[0][q];
    if (want_psy) {
      for (int q = q0; q < q0 + PARTS_TB; ++q) {
        const int cgy = (((q - q0) * 32) >> 4) / NCG;
        if (cgy & 1) continue;              // a bottom half: with its top
        const int qb = q + NCG / 2;          // the CG row below
        const long long es = ((sPart[1][q] + sPart[1][qb]) >> 2) -
                             ((sPart[2][q] + sPart[2][qb]) >> 2);
        const long long er = ((sPart[3][q] + sPart[3][qb]) >> 2) -
                             ((sPart[4][q] + sPart[4][qb]) >> 2);
        psy += es > er ? es - er : er - es;
      }
    }
    long long* o = out + (long long)(tb0 + tid) * 4;
    o[0] = sse;
    o[1] = sCgRate[tid * NCG * NCG];
    o[2] = psy;
    o[3] = sLast[tid] >= 0;
  }
}

template <int S, bool kRdoq>
void launch(const void* src, const void* pred, const void* qp, const void* rk,
            const void* tab, const void* lam, void* out, int n, int is_intra,
            int bd, int sdh, int scaling, int want_psy, cudaStream_t stream) {
  constexpr int TBS = kSlots / (S * S);
  rd_tb_cost_kernel<S, kRdoq><<<(n + TBS - 1) / TBS, kThreads, 0, stream>>>(
      (const int32_t*)src, (const int32_t*)pred, (const int32_t*)qp,
      (const int32_t*)rk, (const int32_t*)tab, (const long long*)lam,
      (long long*)out, n, is_intra, bd, sdh, scaling, want_psy);
}

}  // namespace

// src, pred int32 [n, S, S]; qp int32 [n]; rk int32 [8]; tab int32
// [2 * S * S + 12]; lam int64 [70]; out int64 [n, 4]. S in {8, 16, 32},
// bd in 8..10.
extern "C" int x265_rd_tb_cost(const void* src, const void* pred,
                               const void* qp, const void* rk,
                               const void* tab, const void* lam, void* out,
                               int n, int S, int is_intra, int bd, int sdh,
                               int do_rdoq, int scaling, int want_psy,
                               void* stream) {
  if (n < 1 || bd < 8 || bd > 10) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define X265_RD_LAUNCH(SZ, R)                                                \
  launch<SZ, R>(src, pred, qp, rk, tab, lam, out, n, is_intra, bd, sdh,     \
                scaling, want_psy, st)
  switch (S) {
    case 8:
      if (do_rdoq) X265_RD_LAUNCH(8, true); else X265_RD_LAUNCH(8, false);
      break;
    case 16:
      if (do_rdoq) X265_RD_LAUNCH(16, true); else X265_RD_LAUNCH(16, false);
      break;
    case 32:
      if (do_rdoq) X265_RD_LAUNCH(32, true); else X265_RD_LAUNCH(32, false);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef X265_RD_LAUNCH
  return (int)cudaGetLastError();
}
