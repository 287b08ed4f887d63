// Native slice-data finalizer: decision tensors -> CABAC slice bytes.
//
// This is the framework's serial native component (SURVEY.md §7.2): the
// analysis runs as batched TPU computation, and this C++ walker re-derives
// normative integer predictions/residuals and emits the entropy-coded
// slice. Mirrors x265's compressCTU/encodeCTU split (frameencoder.cpp:1519
// vs 1533) with the decide stage replaced by precomputed decision maps.
//
// Behavior is pinned bin-exactly to the Python reference writer
// (x265_tpu/engine/ctu_writer.py) by differential tests.

#include <stdint.h>
#include <string.h>
#include <stdlib.h>
#include <vector>
#include <cmath>
#include <algorithm>

#include "tables_gen.h"

namespace {

static inline int clip3(int lo, int hi, int v) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// ---------------- CABAC engine (HM carry-buffer formulation) -------------

struct Cabac {
  // collect mode (single-CABAC SAO pipeline): the walk runs with the
  // coder disabled — levels/recon/cbf are gathered, no bins cost time
  bool enabled = true;
  uint8_t ctx[NUM_CONTEXTS];
  uint32_t low = 0;
  int range = 510;
  int bits_left = 23;
  int num_buffered = 0;
  int buffered_byte = 0xFF;
  std::vector<uint8_t> out;

  void init_slice(int init_type, int qp) {
    qp = clip3(0, 51, qp);
    for (int i = 0; i < NUM_CONTEXTS; i++) {
      int iv = kInitVals[init_type * NUM_CONTEXTS + i];
      int slope = (iv >> 4) * 5 - 45;
      int offset = ((iv & 15) << 3) - 16;
      int pre = clip3(1, 126, ((slope * qp) >> 4) + offset);
      int mps = pre > 63 ? 1 : 0;
      int pstate = mps ? pre - 64 : 63 - pre;
      ctx[i] = (uint8_t)((pstate << 1) | mps);
    }
    low = 0; range = 510; bits_left = 23;
    num_buffered = 0; buffered_byte = 0xFF; out.clear();
    out.reserve(1 << 20);
  }

  void write_out() {
    uint32_t lead = low >> (24 - bits_left);
    bits_left += 8;
    low &= 0xFFFFFFFFu >> bits_left;
    if (lead == 0xFF) {
      num_buffered++;
    } else if (num_buffered > 0) {
      int carry = lead >> 8;
      out.push_back((uint8_t)(buffered_byte + carry));
      uint8_t fill = (uint8_t)(0xFF + carry);
      for (int i = 0; i < num_buffered - 1; i++) out.push_back(fill);
      buffered_byte = lead & 0xFF;
      num_buffered = 1;
    } else {
      num_buffered = 1;
      buffered_byte = lead & 0xFF;
    }
  }

  void bin(int ctx_idx, int b) {
    if (!enabled) return;
    uint8_t st = ctx[ctx_idx];
    int lps = kLps[(st >> 1) * 4 + ((range >> 6) & 3)];
    range -= lps;
    if (b != (st & 1)) {
      int n = kRenorm[lps >> 3];
      low = (low + (uint32_t)range) << n;
      range = lps << n;
      ctx[ctx_idx] = kNextLps[st];
      bits_left -= n;
    } else {
      ctx[ctx_idx] = kNextMps[st];
      if (range >= 256) return;
      low <<= 1;
      range <<= 1;
      bits_left -= 1;
    }
    if (bits_left < 12) write_out();
  }

  void ep(int b) {
    if (!enabled) return;
    low <<= 1;
    if (b) low += (uint32_t)range;
    bits_left -= 1;
    if (bits_left < 12) write_out();
  }

  void eps(uint32_t pattern, int nbins) {
    if (!enabled) return;
    while (nbins > 8) {
      nbins -= 8;
      uint32_t chunk = (pattern >> nbins) & 0xFF;
      low = (low << 8) + (uint32_t)range * chunk;
      bits_left -= 8;
      if (bits_left < 12) write_out();
    }
    if (nbins > 0) {
      uint32_t chunk = pattern & ((1u << nbins) - 1);
      low = (low << nbins) + (uint32_t)range * chunk;
      bits_left -= nbins;
      if (bits_left < 12) write_out();
    }
  }

  void trm(int b) {
    if (!enabled) return;
    range -= 2;
    if (b) {
      low = (low + (uint32_t)range) << 7;
      range = 2 << 7;
      bits_left -= 7;
    } else if (range >= 256) {
      return;
    } else {
      low <<= 1;
      range <<= 1;
      bits_left -= 1;
    }
    if (bits_left < 12) write_out();
  }

  void finish() {
    if (!enabled) return;
    if ((low >> (32 - bits_left)) & 1) {
      out.push_back((uint8_t)(buffered_byte + 1));
      for (int i = 0; i < num_buffered - 1; i++) out.push_back(0x00);
      low -= 1u << (32 - bits_left);
    } else {
      if (num_buffered > 0) out.push_back((uint8_t)buffered_byte);
      for (int i = 0; i < num_buffered - 1; i++) out.push_back(0xFF);
    }
    int nbits = 24 - bits_left;
    uint32_t val = nbits > 0 ? (low >> 8) & ((1u << nbits) - 1) : 0;
    nbits += 1;
    val = (val << 1) | 1;               // rbsp stop bit
    int pad = (8 - (nbits & 7)) & 7;
    val <<= pad;
    nbits += pad;
    while (nbits >= 8) {
      nbits -= 8;
      out.push_back((uint8_t)((val >> nbits) & 0xFF));
    }
  }
};

// ---------------- intra prediction (normative integer) -------------------

// ref layout: ref[0..2n-1] left bottom-up, ref[2n] corner, ref[2n+1..4n] top
// cshift: 0 for luma; 1 for chroma, where availability is read from the
// LUMA 4x4 map at (x<<1, y<<1) — avoids materialising a chroma map per TU
static void get_ref_samples(const int16_t* plane, int stride, int pw, int ph,
                            const uint8_t* avail4, int a4stride,
                            int x0, int y0, int nt, int bd, int32_t* ref,
                            int cshift = 0) {
  int n2 = 2 * nt;
  int R = 4 * nt + 1;
  uint8_t av[4 * 32 + 1];         // max intra TB is 32x32
  memset(av, 0, R);
  auto sample_ok = [&](int x, int y) -> bool {
    if (x < 0 || y < 0 || x >= pw || y >= ph) return false;
    return avail4[((y << cshift) >> 2) * a4stride
                  + ((x << cshift) >> 2)] != 0;
  };
  for (int i = 0; i < n2; i++) {
    int y = y0 + n2 - 1 - i, x = x0 - 1;
    if (sample_ok(x, y)) { ref[i] = plane[y * stride + x]; av[i] = 1; }
  }
  if (sample_ok(x0 - 1, y0 - 1)) { ref[n2] = plane[(y0 - 1) * stride + x0 - 1]; av[n2] = 1; }
  for (int i = 0; i < n2; i++) {
    int x = x0 + i, y = y0 - 1;
    if (sample_ok(x, y)) { ref[n2 + 1 + i] = plane[y * stride + x]; av[n2 + 1 + i] = 1; }
  }
  int any = 0;
  for (int i = 0; i < R; i++) any |= av[i];
  if (!any) {
    for (int i = 0; i < R; i++) ref[i] = 1 << (bd - 1);
    return;
  }
  int all = 1;
  for (int i = 0; i < R; i++) all &= av[i];
  if (!all) {
    int first = 0;
    while (!av[first]) first++;
    if (!av[0]) ref[0] = ref[first];
    for (int i = 1; i < R; i++)
      if (!av[i]) ref[i] = ref[i - 1];
  }
}

static bool filter_flag(int mode, int log2) {
  if (mode == 1 || mode == 10 || mode == 26) return false;
  if (log2 == 2) return false;
  if (mode == 0) return true;
  int d = std::min(abs(mode - 26), abs(mode - 10));
  int thresh = log2 == 3 ? 7 : (log2 == 4 ? 1 : 0);
  return d > thresh;
}

static void filter_refs(int32_t* ref, int nt, int mode, bool strong, int bd) {
  int log2 = 0; while ((1 << log2) < nt) log2++;
  if (!filter_flag(mode, log2)) return;
  int n2 = 2 * nt, corner = n2, R = 4 * nt + 1;
  if (strong && nt == 32 &&
      abs(ref[corner] + ref[4 * nt] - 2 * ref[corner + nt]) < (1 << (bd - 5)) &&
      abs(ref[corner] + ref[0] - 2 * ref[nt]) < (1 << (bd - 5))) {
    int c = ref[corner], topend = ref[4 * nt], leftend = ref[0];
    int32_t out[4 * 32 + 1];
    memcpy(out, ref, R * sizeof(int32_t));
    for (int x = 0; x < n2 - 1; x++)
      out[corner + 1 + x] = ((63 - x) * c + (x + 1) * topend + 32) >> 6;
    for (int i = 1; i < n2; i++) {
      int y = n2 - 1 - i;
      out[i] = ((63 - y) * c + (y + 1) * leftend + 32) >> 6;
    }
    out[4 * nt] = topend; out[0] = leftend; out[corner] = c;
    memcpy(ref, out, R * sizeof(int32_t));
  } else {
    int32_t out[4 * 32 + 1];
    memcpy(out, ref, R * sizeof(int32_t));
    for (int i = 1; i < R - 1; i++)
      out[i] = (ref[i - 1] + 2 * ref[i] + ref[i + 1] + 2) >> 2;
    memcpy(ref, out, R * sizeof(int32_t));
  }
}

static void predict_intra(const int32_t* ref, int nt, int mode, int c_idx,
                          int bd, int32_t* dst /*nt*nt*/) {
  int n2 = 2 * nt, corner = n2;
  int maxval = (1 << bd) - 1;
  const int32_t* topp = ref + corner + 1;     // p[x][-1]
  // left: p[-1][y] = ref[n2-1-y]
  auto leftv = [&](int y) { return ref[n2 - 1 - y]; };
  int pc = ref[corner];
  int log2 = 0; while ((1 << log2) < nt) log2++;

  if (mode == 0) {  // planar
    int tr = topp[nt], bl = leftv(nt);
    for (int y = 0; y < nt; y++)
      for (int x = 0; x < nt; x++)
        dst[y * nt + x] = ((nt - 1 - x) * leftv(y) + (x + 1) * tr +
                           (nt - 1 - y) * topp[x] + (y + 1) * bl + nt) >> (log2 + 1);
    return;
  }
  if (mode == 1) {  // DC
    int sum = nt;
    for (int i = 0; i < nt; i++) sum += topp[i] + leftv(i);
    int dc = sum >> (log2 + 1);
    for (int i = 0; i < nt * nt; i++) dst[i] = dc;
    if (c_idx == 0 && nt < 32) {
      for (int x = 1; x < nt; x++) dst[x] = (topp[x] + 3 * dc + 2) >> 2;
      for (int y = 1; y < nt; y++) dst[y * nt] = (leftv(y) + 3 * dc + 2) >> 2;
      dst[0] = (leftv(0) + 2 * dc + topp[0] + 2) >> 2;
    }
    return;
  }
  int angle = kAngle[mode - 2];
  bool vertical = mode >= 18;
  int32_t main[4 * 32 + 8];
  memset(main, 0, (2 * n2 + 8) * sizeof(int32_t));
  int base;
  if (angle < 0) {
    int inv = angle == -32 ? -256 : (int)(8192.0 / angle + (8192.0 / angle >= 0 ? 0.5 : -0.5));
    int lo = (nt * angle) >> 5;
    base = -lo;
    for (int x = lo + 1; x < 0; x++) {
      int k = ((x * inv + 128) >> 8) - 1;
      main[x - lo] = k < 0 ? pc : (vertical ? leftv(k) : topp[k]);
    }
    main[base] = pc;
    for (int i = 0; i < n2; i++)
      main[base + 1 + i] = vertical ? topp[i] : leftv(i);
  } else {
    base = 0;
    main[0] = pc;
    for (int i = 0; i < n2; i++)
      main[1 + i] = vertical ? topp[i] : leftv(i);
    main[n2 + 1] = vertical ? topp[n2 - 1] : leftv(n2 - 1);  // pad
  }
  for (int j = 1; j <= nt; j++) {
    int iidx = (j * angle) >> 5;
    int ifact = (j * angle) & 31;
    for (int i = 0; i < nt; i++) {
      int k = i + iidx + 1 + base;
      int v = ((32 - ifact) * main[k] + ifact * main[k + 1] + 16) >> 5;
      if (vertical) dst[(j - 1) * nt + i] = v;
      else dst[i * nt + (j - 1)] = v;
    }
  }
  if (c_idx == 0 && nt < 32) {
    if (mode == 26) {
      for (int y = 0; y < nt; y++)
        dst[y * nt] = clip3(0, maxval, topp[0] + ((leftv(y) - pc) >> 1));
    } else if (mode == 10) {
      for (int x = 0; x < nt; x++)
        dst[x] = clip3(0, maxval, leftv(0) + ((topp[x] - pc) >> 1));
    }
  }
}

// ---------------- transforms / quant (for the CQP path) ------------------

static const int kCC[33] = {64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78,
                            75, 73, 70, 67, 64, 61, 57, 54, 50, 46, 43, 38,
                            36, 31, 25, 22, 18, 13, 9, 4, 0};
static int cosval(int s) {
  s &= 127;
  if (s <= 32) return kCC[s];
  if (s <= 64) return -kCC[64 - s];
  if (s <= 96) return -kCC[s - 64];
  return kCC[128 - s];
}
static const int32_t kDst4[16] = {29, 55, 74, 84, 74, 74, 0, -74,
                              84, -29, -74, 55, 55, -84, 74, -29};

// the DCT matrices of 4..32 and the 4x4 DST, built once (thread-safe
// static initialisation; the slice bands walk on threads)
struct TMatrices {
  int32_t dct[4][32 * 32];       // n = 4 << i
  TMatrices() {
    for (int i = 0; i < 4; i++) {
      int n = 4 << i, stride = 32 / n;
      for (int k = 0; k < n; k++)
        for (int j = 0; j < n; j++)
          dct[i][k * n + j] = cosval(k * (2 * j + 1) * stride);
    }
  }
};
static const int32_t* tmatrix(int n, bool dst) {
  static const TMatrices m;
  if (dst && n == 4) return kDst4;
  return m.dct[n == 4 ? 0 : (n == 8 ? 1 : (n == 16 ? 2 : 3))];
}

// coeff = (T @ resi @ T^T) with stage shifts (HM forward scaling)
static void fwd_transform(const int32_t* resi, int n, bool dst, int bd, int32_t* coeff) {
  const int32_t* t = tmatrix(n, dst);
  int32_t tmp[32 * 32];
  int log2 = 0; while ((1 << log2) < n) log2++;
  int s1 = log2 + bd - 9, s2 = log2 + 6;
  // tmp[k][y] = sum_x T[k][x] * resi[y][x]  >> s1
  for (int k = 0; k < n; k++)
    for (int y = 0; y < n; y++) {
      int64_t acc = 0;
      for (int x = 0; x < n; x++) acc += (int64_t)t[k * n + x] * resi[y * n + x];
      tmp[k * n + y] = (int32_t)((acc + (1 << (s1 - 1))) >> s1);
    }
  // coeff[ky][kx] = sum_y T[ky][y] * tmp[kx][y] >> s2
  for (int ky = 0; ky < n; ky++)
    for (int kx = 0; kx < n; kx++) {
      int64_t acc = 0;
      for (int y = 0; y < n; y++) acc += (int64_t)t[ky * n + y] * tmp[kx * n + y];
      coeff[ky * n + kx] = (int32_t)((acc + (1 << (s2 - 1))) >> s2);
    }
}

static void inv_transform(const int32_t* coeff, int n, bool dst, int bd, int32_t* resi) {
  const int32_t* t = tmatrix(n, dst);
  int32_t tmp[32 * 32];
  int s1 = 7, s2 = 20 - bd;
  // tmp[y][kx] = sum_ky T[ky][y] * coeff[ky][kx] >> 7, clamp16
  for (int y = 0; y < n; y++)
    for (int kx = 0; kx < n; kx++) {
      int64_t acc = 0;
      for (int ky = 0; ky < n; ky++) acc += (int64_t)t[ky * n + y] * coeff[ky * n + kx];
      tmp[y * n + kx] = clip3(-32768, 32767, (int)((acc + 64) >> s1));
    }
  for (int x = 0; x < n; x++)
    for (int y = 0; y < n; y++) {
      int64_t acc = 0;
      for (int kx = 0; kx < n; kx++) acc += (int64_t)t[kx * n + x] * tmp[y * n + kx];
      resi[y * n + x] = clip3(-32768, 32767, (int)((acc + (1 << (s2 - 1))) >> s2));
    }
}

// default scaling matrices (--scaling-list default; 7.4.5 ScalingFactor
// derivation 7-40..7-46): 4x4 flat 16; 8/16/32 from the 8x8 base
// (kScaling8Intra/Inter, tables_gen.h) nearest-upsampled, DC kept at 16.
// Must match x265_tpu_torch.hevc.tables.default_scaling_matrix exactly.
static const int32_t* default_scaling(int log2, bool intra) {
  static int32_t cache[4][2][32 * 32];
  static bool built = false;
  if (!built) {
    for (int lg = 2; lg <= 5; lg++)
      for (int it = 0; it < 2; it++) {
        int n = 1 << lg;
        int32_t* m = cache[lg - 2][it];
        const int32_t* base = it ? kScaling8Intra : kScaling8Inter;
        for (int y = 0; y < n; y++)
          for (int x = 0; x < n; x++)
            m[y * n + x] = (lg == 2) ? 16
                                     : base[(y * 8 / n) * 8 + (x * 8 / n)];
        if (lg >= 4) m[0] = 16;
      }
    built = true;
  }
  return cache[log2 - 2][intra ? 1 : 0];
}

static void quantize(const int32_t* coeff, int n, int qp, int bd, int32_t* lvl,
                     bool is_intra = true, const int32_t* m = nullptr) {
  int log2 = 0; while ((1 << log2) < n) log2++;
  int per = qp / 6, rem = qp % 6;
  int tr_shift = 15 - bd - log2;
  int qbits = 14 + per + tr_shift;
  int64_t offset = (int64_t)(is_intra ? 171 : 85) << (qbits - 9);
  for (int i = 0; i < n * n; i++) {
    int64_t a = coeff[i] < 0 ? -(int64_t)coeff[i] : coeff[i];
    // per-position quant coef with scaling lists: quantScale*16/m
    // (x265 ScalingList::processScalingListEnc quantCoef derivation)
    int64_t sc = m ? (int64_t)kQuantScale[rem] * 16 / m[i] : kQuantScale[rem];
    int v = (int)std::min<int64_t>((a * sc + offset) >> qbits, 32767);
    lvl[i] = coeff[i] < 0 ? -v : v;
  }
}

static void dequantize(const int32_t* lvl, int n, int qp, int bd, int32_t* out,
                       const int32_t* m = nullptr) {
  int log2 = 0; while ((1 << log2) < n) log2++;
  int per = qp / 6, rem = qp % 6;
  int bd_shift = bd + log2 - 5;
  int64_t scale = (int64_t)kDequantScale[rem] * 16;
  for (int i = 0; i < n * n; i++) {
    int64_t sc = m ? (int64_t)kDequantScale[rem] * m[i] : scale;
    int64_t d = ((int64_t)lvl[i] * (sc << per)) + (1LL << (bd_shift - 1));
    out[i] = clip3(-32768, 32767, (int)(d >> bd_shift));
  }
}

// RDOQ, simplified (Quant::rdoQuant analog; mirrors ops/ref/transform.rdoq):
// per-coefficient level choice among {l, l-1, 0} + whole-CG zeroing with a
// static bin-count rate model. All-integer cost arithmetic (lambda from the
// shared kRdoqLam32 fixed-point table) so the native finalizer, the Python
// oracle and the TPU residual pipeline decide identically:
//   cost*32*err_norm = 32*e^2 + (LAM32[qp] << 2*tr_shift) * rate
// K: optional [8] Q15 fractional-bit constants (the estBit analog;
// hevc/rate_model.py derives them from the slice-initial context
// states and the python/device paths use the same shared formula).
// psy_fx: Q8 psy-rdoq strength (quant.cpp:610 usePsyMask analog, the
// caller gates it to luma): AC coefficients earn an energy credit
// (psy_fx * 32 * |dequant(l)|) >> 8 favouring the larger level.
static void rdoq_adjust(const int32_t* coeff, int32_t* lvl, int n, int qp,
                        int bd, const int32_t* m = nullptr,
                        const int32_t* K = nullptr, int psy_fx = 0) {
  int log2 = 0; while ((1 << log2) < n) log2++;
  int per = qp / 6, rem = qp % 6;
  int bd_shift = bd + log2 - 5;
  int64_t scale = (int64_t)kDequantScale[rem] * 16;
  int tr_shift = 15 - bd - log2;
  // estBit path: real fractional bits get the full lambda2; the static
  // bin-count model keeps its 0.4-calibrated table (tables.py)
  int64_t lam_fx = (K ? kRdoqLam32Full[qp] : kRdoqLam32[qp])
                   << (2 * tr_shift);
  auto deq = [&](int64_t l, int i) {
    int64_t sc = m ? (int64_t)kDequantScale[rem] * m[i] : scale;
    return (l * (sc << per)) >> bd_shift;
  };
  // lam-weighted rate cost of coding |level| l (shared formula,
  // hevc/rate_model.py module doc)
  auto rcost = [&](int64_t l) -> int64_t {
    if (K) {
      int64_t fx;
      if (l == 0) fx = K[0];
      else {
        fx = (int64_t)K[1] + 32768;
        if (l == 1) fx += K[2];
        else {
          fx += K[3];
          if (l == 2) fx += K[4];
          else {
            int64_t remb;
            if (l < 6) remb = (l - 2) << 15;
            else {
              int lg = 63 - __builtin_clzll((uint64_t)(l - 5));
              remb = (int64_t)(4 + 2 * lg) << 15;
            }
            fx += K[5] + remb;
          }
        }
      }
      return (lam_fx * fx) >> 15;
    }
    if (l == 0) return lam_fx;
    int64_t r = 3;                        // sig + gt1 + sign
    if (l > 1) r += 2 + 2 * (63 - __builtin_clzll((uint64_t)l));
    return lam_fx * r;
  };
  for (int i = 0; i < n * n; i++) {
    int64_t c = coeff[i];
    int s = lvl[i] < 0 ? -1 : 1;
    int64_t l0 = lvl[i] < 0 ? -(int64_t)lvl[i] : lvl[i];
    if (l0 == 0) continue;
    int64_t best = INT64_MAX;
    int64_t bl = l0;
    int64_t cands[3] = {l0, l0 - 1, 0};
    for (int64_t l : cands) {
      int64_t e = c - s * deq(l, i);
      int64_t cost = 32 * e * e + rcost(l);
      if (psy_fx && i) cost -= ((int64_t)psy_fx * 32 * deq(l, i)) >> 8;
      if (cost < best) { best = cost; bl = l; }
    }
    lvl[i] = (int32_t)(s * bl);
  }
  // CG zeroing (the csbf bin flips 1 -> 0 when the group clears)
  int ng = n / 4;
  for (int cy = 0; cy < ng; cy++)
    for (int cx = 0; cx < ng; cx++) {
      int64_t d_now = 0, d_zero = 0, r_now = 0;
      bool any = false;
      for (int j = 0; j < 4; j++)
        for (int i = 0; i < 4; i++) {
          int idx = (cy * 4 + j) * n + cx * 4 + i;
          int64_t c = coeff[idx];
          int64_t l = lvl[idx] < 0 ? -(int64_t)lvl[idx] : lvl[idx];
          int s = lvl[idx] < 0 ? -1 : 1;
          int64_t e = c - s * deq(l, idx);
          d_now += e * e;
          d_zero += c * c;
          r_now += rcost(l);
          if (psy_fx && idx) r_now -= ((int64_t)psy_fx * 32
                                       * deq(l, idx)) >> 8;
          if (l) any = true;
        }
      int64_t save = K ? r_now + ((lam_fx * (int64_t)(K[7] - K[6])) >> 15)
                       : r_now - lam_fx;
      if (any && 32 * (d_zero - d_now) < save) {
        for (int j = 0; j < 4; j++)
          for (int i = 0; i < 4; i++)
            lvl[(cy * 4 + j) * n + cx * 4 + i] = 0;
      }
    }
}

// sign-bit-hiding pre-adjust (encoder choice; matches python reference)
static void sbh_adjust(int32_t* lvl, int n, const uint16_t* scan) {
  for (int cg = 0; cg < n * n; cg += 16) {
    int first = -1, last = -1;
    int64_t asum = 0;
    for (int k = 0; k < 16; k++) {
      int v = lvl[scan[cg + k]];
      if (v) {
        if (first < 0) first = k;
        last = k;
        asum += v < 0 ? -v : v;
      }
    }
    if (first < 0 || last - first <= 3) continue;
    int want = lvl[scan[cg + first]] < 0 ? 1 : 0;
    if ((asum & 1) != want) {
      int32_t& v = lvl[scan[cg + first]];
      if (v == 1) v = 2;
      else if (v == -1) v = -2;
      else v += v > 0 ? -1 : 1;
    }
  }
}

// ---------------- fractional-sample interpolation (8.5.4.2.2) -----------

static const int kLumaFilt[4][8] = {
    {0, 0, 0, 64, 0, 0, 0, 0},
    {-1, 4, -10, 58, 17, -5, 1, 0},
    {-1, 4, -11, 40, 40, -11, 4, -1},
    {0, 1, -5, 17, 58, -10, 4, -1}};
static const int kChromaFilt[8][4] = {
    {0, 64, 0, 0},  {-2, 58, 10, -2}, {-4, 54, 16, -2}, {-6, 46, 28, -4},
    {-4, 36, 36, -4}, {-4, 28, 46, -6}, {-2, 16, 54, -4}, {-2, 10, 58, -2}};

// MC to 14-bit prediction. refp: padded plane (pad each side), stride =
// plane width + 2*pad. mv in units of 1/2^fb pel. luma: fb=2, ntaps=8;
// chroma: fb=3, ntaps=4 (mv is the luma quarter-pel value).
static void mc_14(const int16_t* refp, int stride, int pad, int x0, int y0,
                  int w, int h, int mvx, int mvy, int fb, bool luma, int bd,
                  int32_t* out) {
  int ntaps = luma ? 8 : 4;
  int half = ntaps / 2;
  int mask = (1 << fb) - 1;
  int xi = x0 + (mvx >> fb), xf = mvx & mask;
  int yi = y0 + (mvy >> fb), yf = mvy & mask;
  int shift1 = bd - 8;
  const int* fx = luma ? kLumaFilt[xf] : kChromaFilt[xf];
  const int* fy = luma ? kLumaFilt[yf] : kChromaFilt[yf];
  const int16_t* base = refp + (pad + yi) * stride + (pad + xi);
  if (xf == 0 && yf == 0) {
    for (int j = 0; j < h; j++)
      for (int i = 0; i < w; i++)
        out[j * w + i] = (int32_t)base[j * stride + i] << (14 - bd);
    return;
  }
  if (yf == 0) {
    for (int j = 0; j < h; j++)
      for (int i = 0; i < w; i++) {
        int64_t acc = 0;
        const int16_t* p = base + j * stride + i - half + 1;
        for (int t = 0; t < ntaps; t++) acc += (int64_t)fx[t] * p[t];
        out[j * w + i] = (int32_t)(acc >> shift1);
      }
    return;
  }
  if (xf == 0) {
    for (int j = 0; j < h; j++)
      for (int i = 0; i < w; i++) {
        int64_t acc = 0;
        const int16_t* p = base + (j - half + 1) * stride + i;
        for (int t = 0; t < ntaps; t++) acc += (int64_t)fy[t] * p[t * stride];
        out[j * w + i] = (int32_t)(acc >> shift1);
      }
    return;
  }
  // horizontal into tmp rows (h + ntaps - 1), then vertical
  int32_t tmp[(64 + 7) * 64];     // a 64x64 CU's luma
  for (int j = 0; j < h + ntaps - 1; j++)
    for (int i = 0; i < w; i++) {
      int64_t acc = 0;
      const int16_t* p = base + (j - half + 1) * stride + i - half + 1;
      for (int t = 0; t < ntaps; t++) acc += (int64_t)fx[t] * p[t];
      tmp[j * w + i] = (int32_t)(acc >> shift1);
    }
  for (int j = 0; j < h; j++)
    for (int i = 0; i < w; i++) {
      int64_t acc = 0;
      for (int t = 0; t < ntaps; t++) acc += (int64_t)fy[t] * tmp[(j + t) * w + i];
      out[j * w + i] = (int32_t)(acc >> 6);
    }
}

static void unipred_px(const int32_t* p14, int n, int bd, int32_t* out) {
  int shift = 14 - bd, off = 1 << (shift - 1), maxv = (1 << bd) - 1;
  for (int i = 0; i < n; i++) out[i] = clip3(0, maxv, (p14[i] + off) >> shift);
}
// Explicit weighted uni prediction (8.5.4.2.3.2): log2Wd = denom + 14 - bd
static void weighted_unipred_px(const int32_t* p14, int n, int bd, int wgt,
                                int off, int denom, int32_t* out) {
  int log2wd = denom + 14 - bd, maxv = (1 << bd) - 1;
  int64_t o = (int64_t)off << (bd - 8);
  if (log2wd >= 1) {
    int64_t rnd = 1ll << (log2wd - 1);
    for (int i = 0; i < n; i++)
      out[i] = clip3(0, maxv,
                     (int32_t)((((int64_t)p14[i] * wgt + rnd) >> log2wd) + o));
  } else {
    for (int i = 0; i < n; i++)
      out[i] = clip3(0, maxv, (int32_t)((int64_t)p14[i] * wgt + o));
  }
}
static void bipred_px(const int32_t* a, const int32_t* b, int n, int bd,
                      int32_t* out) {
  int shift = 15 - bd, off = 1 << (shift - 1), maxv = (1 << bd) - 1;
  for (int i = 0; i < n; i++)
    out[i] = clip3(0, maxv, (a[i] + b[i] + off) >> shift);
}

// ---------------- merge / AMVP (8.5.3.2.3-8.5.3.2.8) ---------------------

struct Motion {
  int dir = 0;            // bitmask 1=L0, 2=L1
  int mv[2][2] = {{0, 0}, {0, 0}};
  int ref[2] = {-1, -1};
};

static bool same_motion(const Motion& a, const Motion& b) {
  if (a.dir != b.dir) return false;
  for (int l = 0; l < 2; l++)
    if (a.dir & (1 << l)) {
      if (a.mv[l][0] != b.mv[l][0] || a.mv[l][1] != b.mv[l][1] ||
          a.ref[l] != b.ref[l])
        return false;
    }
  return true;
}

static void scale_mv(int mvx, int mvy, int tb, int td, int* ox, int* oy) {
  if (td == tb) { *ox = mvx; *oy = mvy; return; }
  td = clip3(-128, 127, td);
  tb = clip3(-128, 127, tb);
  int q = 16384 + (abs(td) >> 1);
  int tx = td > 0 ? q / td : -(q / -td);
  int dsf = clip3(-4096, 4095, (tb * tx + 32) >> 6);
  auto sc = [&](int v) {
    int64_t p = (int64_t)dsf * v;
    int s = (int)((p < 0 ? -p : p) + 127 >> 8);
    return clip3(-32768, 32767, p >= 0 ? s : -s);
  };
  *ox = sc(mvx);
  *oy = sc(mvy);
}

static const int kCombPairs[12][2] = {{0, 1}, {1, 0}, {0, 2}, {2, 0},
                                      {1, 2}, {2, 1}, {0, 3}, {3, 0},
                                      {1, 3}, {3, 1}, {2, 3}, {3, 2}};

// ---------------- residual_coding --------------------------------------

static const uint16_t* scan_tab(int log2, int si) {
  switch (log2) {
    case 2: return si == 0 ? kScan4_0 : (si == 1 ? kScan4_1 : kScan4_2);
    case 3: return si == 0 ? kScan8_0 : (si == 1 ? kScan8_1 : kScan8_2);
    case 4: return kScan16_0;
    default: return kScan32_0;
  }
}
static const uint16_t* cg_scan_tab(int log2, int si) {
  switch (log2) {
    case 2: return si == 0 ? kScanCG4_0 : (si == 1 ? kScanCG4_1 : kScanCG4_2);
    case 3: return si == 0 ? kScanCG8_0 : (si == 1 ? kScanCG8_1 : kScanCG8_2);
    case 4: return kScanCG16_0;
    default: return kScanCG32_0;
  }
}

static int scan_index(int log2, int c_idx, int mode, bool is_intra) {
  if (is_intra && (log2 == 2 || (log2 == 3 && c_idx == 0))) {
    if (mode >= 6 && mode <= 14) return 2;   // vertical
    if (mode >= 22 && mode <= 30) return 1;  // horizontal
  }
  return 0;
}

static int sig_ctx(int x, int y, int log2, bool luma, int si, int prev_csbf) {
  if (log2 == 2) return kSigCtx4x4[(y << 2) + x];
  if (x + y == 0) return 0;
  int xp = x & 3, yp = y & 3, cnt;
  if (prev_csbf == 0) {
    int s = xp + yp;
    cnt = s == 0 ? 2 : (s <= 2 ? 1 : 0);
  } else if (prev_csbf == 1) {
    cnt = yp == 0 ? 2 : (yp == 1 ? 1 : 0);
  } else if (prev_csbf == 2) {
    cnt = xp == 0 ? 2 : (xp == 1 ? 1 : 0);
  } else {
    cnt = 2;
  }
  int base = ((x >> 2) + (y >> 2)) == 0 ? 0 : (luma ? 3 : 0);
  int offset = luma ? (log2 == 3 ? (si == 0 ? 9 : 15) : 21)
                    : (log2 == 3 ? 9 : 12);
  return base + offset + cnt;
}

static void encode_remain(Cabac& cab, int value, int rice) {
  if (value < (3 << rice)) {
    int length = value >> rice;   // <= 2
    // prefix (length+1 unary bins) + rice suffix in ONE bypass batch
    uint32_t pat = (((1u << (length + 1)) - 2) << rice)
                   | (uint32_t)(value & ((1 << rice) - 1));
    cab.eps(pat, length + 1 + rice);
  } else {
    int length = rice;
    value -= 3 << rice;
    while (value >= (1 << length)) { value -= 1 << length; length++; }
    int npre = 3 + length + 1 - rice;
    if (npre + length <= 31) {
      cab.eps(((((1u << npre) - 2) << length) | (uint32_t)value),
              npre + length);
    } else {
      cab.eps((1u << npre) - 2, npre);
      cab.eps(value, length);
    }
  }
}

// lv: the TB's levels, int16 rows `stride` apart
static void encode_residual(Cabac& cab, const int16_t* lv, int stride,
                            int log2, int c_idx, int si, bool sign_hiding,
                            bool tqb, int ts = -1) {
  if (!cab.enabled) return;      // collect-only pass: bins are no-ops
  int n = 1 << log2;
  bool luma = c_idx == 0;
  // transform_skip_flag (7.3.8.11): present for 4x4 TBs with --tskip,
  // coded before the last-position syntax (decoder parse order)
  if (ts >= 0)
    cab.bin(luma ? CTX_TRANSFORM_SKIP_LUMA : CTX_TRANSFORM_SKIP_CHROMA, ts);
  const uint16_t* scan = scan_tab(log2, si);
  const uint16_t* cgs = cg_scan_tab(log2, si);
  int ncoef = n * n;
  int32_t levels[32 * 32];      // max TB is 32x32
  int last_scan = -1;
  for (int i = 0; i < ncoef; i++) {
    int r = scan[i];
    levels[i] = lv[(r >> log2) * stride + (r & (n - 1))];
    if (levels[i]) last_scan = i;
  }
  // last position
  int lr = scan[last_scan];
  int lx = lr % n, ly = lr / n;
  if (si == 2) std::swap(lx, ly);
  {
    int gx = kGroupIdx[lx], gy = kGroupIdx[ly];
    int offset = luma ? 3 * (log2 - 2) + ((log2 - 1) >> 2) : 0;
    int shift = luma ? (log2 + 1) >> 2 : log2 - 2;
    int cmax = (log2 << 1) - 1;
    int ox = luma ? CTX_LAST_X_LUMA : CTX_LAST_X_CHROMA;
    int oy = luma ? CTX_LAST_Y_LUMA : CTX_LAST_Y_CHROMA;
    for (int i = 0; i < gx; i++) cab.bin(ox + offset + (i >> shift), 1);
    if (gx < cmax) cab.bin(ox + offset + (gx >> shift), 0);
    for (int i = 0; i < gy; i++) cab.bin(oy + offset + (i >> shift), 1);
    if (gy < cmax) cab.bin(oy + offset + (gy >> shift), 0);
    if (gx > 3) cab.eps(lx - kMinInGroup[gx], (gx >> 1) - 1);
    if (gy > 3) cab.eps(ly - kMinInGroup[gy], (gy >> 1) - 1);
  }
  int ng = n >> 2 ? n >> 2 : 1;
  int num_cgs = (last_scan >> 4) + 1;
  uint8_t csbf[8 * 8];
  memset(csbf, 0, ng * ng);
  for (int ci = 0; ci < num_cgs; ci++) {
    for (int k = 0; k < 16; k++)
      if (levels[(ci << 4) + k]) { csbf[cgs[ci]] = 1; break; }
  }
  int c1 = 1;
  int csbf_base = luma ? CTX_CSBF_LUMA : CTX_CSBF_CHROMA;
  int sig_base = luma ? CTX_SIG_LUMA : CTX_SIG_CHROMA;
  int g1_base = luma ? CTX_GT1_LUMA : CTX_GT1_CHROMA;
  int g2_base = luma ? CTX_GT2_LUMA : CTX_GT2_CHROMA;
  for (int ci = num_cgs - 1; ci >= 0; ci--) {
    int cgr = cgs[ci];
    int cgx = cgr % ng, cgy = cgr / ng;
    int right = cgx + 1 < ng ? csbf[cgy * ng + cgx + 1] : 0;
    int below = cgy + 1 < ng ? csbf[(cgy + 1) * ng + cgx] : 0;
    bool is_last = ci == num_cgs - 1;
    bool infer_dc = false;
    if (is_last || ci == 0) {
      csbf[cgr] = 1;
    } else {
      cab.bin(csbf_base + ((right || below) ? 1 : 0), csbf[cgr]);
      infer_dc = csbf[cgr] != 0;
    }
    if (!csbf[cgr]) continue;
    int start = is_last ? (last_scan & 15) - 1 : 15;
    int sig_pos[16], nsig = 0;
    if (is_last) sig_pos[nsig++] = last_scan & 15;
    int prev_csbf = right + 2 * below;
    for (int k = start; k >= 0; k--) {
      if (k == 0 && infer_dc && nsig == 0) { sig_pos[nsig++] = 0; break; }
      int r = scan[(ci << 4) + k];
      int x = r % n, y = r / n;
      int sig = levels[(ci << 4) + k] != 0;
      cab.bin(sig_base + sig_ctx(x, y, log2, luma, si, prev_csbf), sig);
      if (sig) sig_pos[nsig++] = k;
    }
    // sort positions descending (they already are, by construction)
    int nnz = nsig;
    int abs_vals[16], signs[16];
    for (int i = 0; i < nnz; i++) {
      int v = levels[(ci << 4) + sig_pos[i]];
      abs_vals[i] = v < 0 ? -v : v;
      signs[i] = v < 0 ? 1 : 0;
    }
    int ctx_set = ((ci > 0 && luma) ? 2 : 0) + (c1 == 0 ? 1 : 0);
    c1 = 1;
    int num_c1 = std::min(nnz, 8);
    int first_g2 = -1;
    for (int i = 0; i < num_c1; i++) {
      int sym = abs_vals[i] > 1;
      cab.bin(g1_base + 4 * ctx_set + c1, sym);
      if (sym) {
        c1 = 0;
        if (first_g2 < 0) first_g2 = i;
      } else if (c1 > 0 && c1 < 3) {
        c1++;
      }
    }
    if (first_g2 >= 0) cab.bin(g2_base + ctx_set, abs_vals[first_g2] > 2);
    if (nnz == 0) { c1 = 1; continue; }
    bool hidden = sign_hiding && !tqb &&
                  sig_pos[0] - sig_pos[nnz - 1] > 3;
    int n_signs = hidden ? nnz - 1 : nnz;
    for (int i = 0; i < n_signs; i++) cab.ep(signs[i]);
    int rice = 0;
    for (int i = 0; i < nnz; i++) {
      int base = i < 8 ? (i == first_g2 ? 3 : 2) : 1;
      if (abs_vals[i] >= base) encode_remain(cab, abs_vals[i] - base, rice);
      if (abs_vals[i] > (3 << rice)) rice = std::min(rice + 1, 4);
    }
  }
}

// ---------------- frame walker ------------------------------------------

struct Writer {
  // picture geometry / params
  int width, height, ctb_log2, min_cb_log2;
  int qp, bd;
  int rdoq_level = 0;
  int psy_fx = 0;              // Q8 psy-rdoq strength (luma RDOQ only)
  // estBit fractional-bit RDOQ constants ([16]: luma row then chroma
  // row; null = static bin-count model). See hevc/rate_model.py.
  const int32_t* rate_consts = nullptr;
  const int32_t* rk(int pl) const {
    return rate_consts ? rate_consts + (pl == 0 ? 0 : 8) : nullptr;
  }
  bool lossless, sign_hiding, strong_smooth;
  bool bad = false;            // invalid decision maps: caller gets -1
  int cb_qp_off, cr_qp_off;
  // recon planes, reconstructed in place: the device recon of the
  // precomputed CUs is already there, the walk writes the rest. Null when
  // every CU is precomputed (the emit-only replay writes no sample).
  int16_t *y = nullptr, *cb = nullptr, *cr = nullptr;
  const uint16_t *src_y, *src_cb, *src_cr;
  // maps
  const int32_t *cu_log2_map, *luma_mode8, *chroma_mode8;
  int w8;
  // inter decision maps / references (slice_type != I)
  int slice_type = 2;                 // 2=I, 1=P, 0=B (syntax values)
  const uint8_t* inter8 = nullptr;    // [h8*w8]
  const int32_t* dir8 = nullptr;      // [h8*w8]
  const int32_t* mv8 = nullptr;       // [h8*w8*2*2] (list, x/y)
  static const int kMaxRef = 4;
  const int16_t* refp[2][4][3] = {{{nullptr}}};  // [list][ref][plane]
  // explicit P-slice weights (pred_weight_table): [4 L0 refs][3 planes]
  // x (flag, w, off); denoms per luma/chroma. null = unweighted.
  const int32_t* wp = nullptr;
  int wp_ldenom = 0, wp_cdenom = 0;
  // TMVP collocated motion (16x16 compressed, 8.5.3.2.7-8.5.3.2.9):
  // col_dir [h16*w16] bitmask (0=intra), col_mv [h16*w16*2*2],
  // col_refpoc [h16*w16*2]; active iff col_dir != null
  const int32_t* col_dir = nullptr;
  const int32_t* col_mv = nullptr;
  const int32_t* col_refpoc = nullptr;
  int col_poc = 0, col_from_l0 = 1;
  // DCT-domain noise reduction (x265 denoiseDct / noiseReductionUpdate,
  // quant.cpp:444, frameencoder.cpp:2098 — libavcodec adaptive deadzone).
  // cat = sizeIdx + 4*!isLuma + 8*!isIntra; DC never denoised (offset 0).
  const uint16_t* nr_off = nullptr;   // [16][1024] in
  uint32_t* nr_sum = nullptr;         // [16][1024] accumulated out
  uint32_t* nr_cnt = nullptr;         // [16] accumulated out

  void denoise(int32_t* cf, int n, int log2, int plane, bool is_intra) {
    if (!nr_off) return;
    int cat = (log2 - 2) + 4 * (plane != 0) + 8 * (!is_intra);
    const uint16_t* off = nr_off + cat * 1024;
    uint32_t* sum = nr_sum + cat * 1024;
    int nc = n * n;
    for (int i = 0; i < nc; i++) {
      int level = cf[i];
      int sign = level >> 31;
      level = (level + sign) ^ sign;
      sum[i] += (uint32_t)level;
      level -= off[i];
      cf[i] = level < 0 ? 0 : (level ^ sign) - sign;
    }
    nr_cnt[cat]++;
  }
  const int32_t* ref8 = nullptr;                 // [h8*w8] L0 ref idx
  // --- precomputed residual tensors (the TPU decide/emit split; the
  // device ran prediction/transform/quant/recon — frameencoder.cpp:1519's
  // compressCTU analog — and this writer only emits bins, :1533) ---
  int16_t* pre_lvl_y = nullptr;         // [h*w] TU levels, raster layout
  int16_t* pre_lvl_cb = nullptr;        // [h/2 * w/2]
  int16_t* pre_lvl_cr = nullptr;
  uint8_t* pre_cbf8 = nullptr;          // [h8*w8] bit0=y bit1=cb bit2=cr
  uint8_t* pre_has8 = nullptr;          // [h8*w8] 1 = CU is precomputed
  const uint8_t* pre_tus8 = nullptr;    // [h8*w8] inter RQT split flag
  int max_trafo_inter = 0;              // sps.max_transform_hierarchy_inter
  bool pre_cu(int x0, int y0) const {
    return pre_has8 && pre_has8[(y0 >> 3) * w8 + (x0 >> 3)];
  }
  // where the residual coder reads a TB's levels: int16 rows `stride`
  // apart, in the pre_* planes (a precomputed TB, at x0, y0 in the
  // plane's samples) or in a buffer of the walk's own (a computed TB)
  struct Lv {
    const int16_t* p = nullptr;
    int stride = 0;
  };
  Lv pre_tb(int plane, int x0, int y0) const {
    int pw = plane == 0 ? width : width >> 1;
    const int16_t* lp = plane == 0 ? pre_lvl_y
                        : (plane == 1 ? pre_lvl_cb : pre_lvl_cr);
    return {lp + y0 * pw + x0, pw};
  }
  static Lv own_tb(const int32_t* lvl, int n, int16_t* buf) {
    for (int i = 0; i < n * n; i++) buf[i] = (int16_t)lvl[i];
    return {buf, n};
  }
  // collect mode: the TBs the walk computes join the precomputed ones in
  // the pre_* planes (levels, cbf, has8), so that a later emit-only walk
  // replays every TB from them (ONE real CABAC pass per frame even with
  // SAO; x265 derives SAO from stats without re-encoding, sao.cpp:1225).
  // A CU's has8 is read once, before its TBs are exported.
  bool collect = false;
  void export_tb(int plane, int x0, int y0, int nt, const int32_t* lvl,
                 bool cbf) {
    if (!collect) return;
    int pw = plane == 0 ? width : width >> 1;
    int16_t* dst = plane == 0 ? pre_lvl_y
                              : (plane == 1 ? pre_lvl_cb : pre_lvl_cr);
    if (cbf)
      for (int j = 0; j < nt; j++)
        for (int i = 0; i < nt; i++)
          dst[(y0 + j) * pw + (x0 + i)] = (int16_t)lvl[j * nt + i];
    int lx0 = plane == 0 ? x0 : x0 << 1;
    int ly0 = plane == 0 ? y0 : y0 << 1;
    int ln = plane == 0 ? nt : nt << 1;
    for (int by = ly0 >> 3; by < (ly0 + ln) >> 3; by++)
      for (int bx = lx0 >> 3; bx < (lx0 + ln) >> 3; bx++) {
        if (cbf) pre_cbf8[by * w8 + bx] |= (uint8_t)(1 << plane);
        pre_has8[by * w8 + bx] = 1;
      }
  }
  int pad_luma = 80;
  // --scaling-list default: per-size spec default matrices in
  // quant/dequant/RDOQ (scalinglist.cpp analog); 0 = flat
  int scaling = 0;
  const int32_t* sm(int n, bool intra) const {
    if (!scaling) return nullptr;
    int lg = 0; while ((1 << lg) < n) lg++;
    return default_scaling(lg, intra);
  }
  // --tskip: transform_skip_flag on 4x4 TBs; the compute functions store
  // the per-plane decision here and the residual emitters read it back
  int tskip = 0;
  int ts_flag[3] = {-1, -1, -1};
  // transform-skip candidate for a 4x4 TB (quant.cpp transformNxN tskip
  // branch). Both chains are ranked with the shared integer RD cost
  // (32*SSE + kRdoqLam32[qp]*rate) so oracle and native pick alike.
  // Returns the flag (0/1) and overwrites lvl/rres when skip wins.
  int try_tskip(const int32_t* resi, int qpc, bool is_intra,
                const int32_t* mtx, const uint16_t* scan,
                int32_t* lvl, int32_t* rres, const int32_t* K = nullptr,
                int psy = 0) {
    int32_t cfs[16], lvs[16], rrs[16];
    int tsh = 13 - bd;
    for (int i = 0; i < 16; i++) cfs[i] = resi[i] << tsh;
    quantize(cfs, 4, qpc, bd, lvs, is_intra, mtx);
    bool nz = false;
    for (int i = 0; i < 16; i++) if (lvs[i]) { nz = true; break; }
    if (rdoq_level > 0 && nz) {
      rdoq_adjust(cfs, lvs, 4, qpc, bd, mtx, K, psy);
      nz = false;
      for (int i = 0; i < 16; i++) if (lvs[i]) { nz = true; break; }
    }
    if (nz && sign_hiding) {
      sbh_adjust(lvs, 4, scan);
      nz = false;
      for (int i = 0; i < 16; i++) if (lvs[i]) { nz = true; break; }
    }
    if (nz) {
      int32_t deq[16];
      dequantize(lvs, 4, qpc, bd, deq, mtx);
      int s2 = 20 - bd;   // ts inverse (8.6.4.2): (deq<<7 + rnd) >> (20-bd)
      for (int i = 0; i < 16; i++)
        rrs[i] = clip3(-32768, 32767,
                       (int)((((int64_t)deq[i] << 7) + (1LL << (s2 - 1)))
                             >> s2));
    } else {
      memset(rrs, 0, sizeof(rrs));
    }
    auto rate1 = [](int64_t l) -> int64_t {
      if (l < 0) l = -l;
      if (l == 0) return 1;
      int64_t r = 3;
      if (l > 1) r += 2 + 2 * (63 - __builtin_clzll((uint64_t)l));
      return r;
    };
    auto cost32 = [&](const int32_t* lv, const int32_t* rr) -> int64_t {
      int64_t sse = 0, rate = 0;
      bool any = false;
      for (int i = 0; i < 16; i++) {
        int64_t e = (int64_t)resi[i] - rr[i];
        sse += e * e;
        rate += rate1(lv[i]);
        if (lv[i]) any = true;
      }
      return 32 * sse + kRdoqLam32[qpc] * (any ? rate : 0);
    };
    if (cost32(lvs, rrs) < cost32(lvl, rres)) {
      memcpy(lvl, lvs, sizeof(lvs));
      memcpy(rres, rrs, sizeof(rrs));
      return 1;
    }
    return 0;
  }
  int ref_poc[2][4] = {{0}};
  int nref[2] = {0, 0};
  int cur_poc = 0;
  int max_merge = 5;
  // per-CTB QP map (cu_qp_delta; null => single slice QP)
  const int32_t* qp_map = nullptr;
  int qp_prev = 0, qg_wanted = 0;
  bool qg_coded = false;
  int32_t* qp_actual = nullptr;        // [h4*w4] decoded-side QpY, every CU

  void maybe_code_dqp(bool any_cbf) {
    if (!qp_map || qg_coded || !any_cbf) return;
    int delta = qg_wanted - qp_prev;
    int a = abs(delta);
    int prefix = std::min(a, 5);
    for (int i = 0; i < prefix; i++)
      cab.bin(CTX_CU_QP_DELTA + (i == 0 ? 0 : 1), 1);
    if (prefix < 5)
      cab.bin(CTX_CU_QP_DELTA + (prefix == 0 ? 0 : 1), 0);
    if (a >= 5) {
      int v = a - 5, k = 0;
      while (v >= (1 << k)) { cab.ep(1); v -= 1 << k; k++; }
      cab.ep(0);
      for (int i = k - 1; i >= 0; i--) cab.ep((v >> i) & 1);
    }
    if (a > 0) cab.ep(delta < 0 ? 1 : 0);
    qg_coded = true;
  }

  // SAO parameter maps (per CTU; null => no SAO syntax)
  int sao_luma = 0, sao_chroma = 0;
  const int32_t *sao_type_y = nullptr, *sao_class_y = nullptr,
                *sao_off_y = nullptr, *sao_type_c = nullptr,
                *sao_class_cb = nullptr, *sao_class_cr = nullptr,
                *sao_off_cb = nullptr, *sao_off_cr = nullptr;
  int wc_ctbs = 0;
  // multi-slice (x265 --slices, frameencoder.cpp:820-876): this writer
  // instance covers CTU addresses [ctb_begin, ctb_begin + ctb_count);
  // availability starts false outside, so intra refs / merge / MPM
  // treat other slices as unavailable (spec slice isolation)
  int ctb_begin = 0;
  int ctb_count = -1;          // -1 = whole picture
  int wpp = 0;                 // emit WPP per-row substreams
  int32_t* ss_sizes = nullptr;  // raw substream byte sizes out
  int ss_cap = 0;
  int n_ss = 0;
  // state: 4x4-grid maps. Every CU writes all of its entries before
  // avail4 marks them, and every read is of an available entry, so only
  // avail4 is cleared per walk (the maps persist in a Scratch).
  std::vector<uint8_t> avail4, isintra4;
  std::vector<int16_t> mode4;
  std::vector<uint8_t> depth4;
  std::vector<uint8_t> skip4;
  std::vector<int32_t> mv4;           // [h4*w4*2*2]
  std::vector<int8_t> ref4;           // [h4*w4*2]
  uint8_t* cbf4 = nullptr;            // [h4*w4] luma cbf out, every CU
  int w4, h4;
  int n_cus = 0, n_host_cus = 0;      // CUs walked / reconstructed here
  Cabac cab;

  // ---- sao() syntax (7.3.8.3) ----
  bool sao_params_equal(int a, int b) const {
    if (sao_type_y[a] != sao_type_y[b] || sao_class_y[a] != sao_class_y[b])
      return false;
    if (sao_type_c[a] != sao_type_c[b] ||
        sao_class_cb[a] != sao_class_cb[b] ||
        sao_class_cr[a] != sao_class_cr[b])
      return false;
    for (int i = 0; i < 4; i++)
      if (sao_off_y[a * 4 + i] != sao_off_y[b * 4 + i] ||
          sao_off_cb[a * 4 + i] != sao_off_cb[b * 4 + i] ||
          sao_off_cr[a * 4 + i] != sao_off_cr[b * 4 + i])
        return false;
    return true;
  }

  void write_tr_offset(int v, int cmax) {
    for (int i = 0; i < v; i++) cab.ep(1);
    if (v < cmax) cab.ep(0);
  }

  void write_sao(int cy_i, int cx_i, bool first_row_of_slice = false) {
    int idx = cy_i * wc_ctbs + cx_i;
    int max_off = (1 << (std::min(bd, 10) - 5)) - 1;
    if (cx_i > 0) {
      if (sao_params_equal(idx, idx - 1)) { cab.bin(CTX_SAO_MERGE, 1); return; }
      cab.bin(CTX_SAO_MERGE, 0);
    }
    if (cy_i > 0 && !first_row_of_slice) {
      if (sao_params_equal(idx, idx - wc_ctbs)) { cab.bin(CTX_SAO_MERGE, 1); return; }
      cab.bin(CTX_SAO_MERGE, 0);
    }
    for (int c_idx = 0; c_idx < 3; c_idx++) {
      if (c_idx == 0 && !sao_luma) continue;
      if (c_idx > 0 && !sao_chroma) continue;
      int typ = c_idx == 0 ? sao_type_y[idx] : sao_type_c[idx];
      if (c_idx <= 1) {
        cab.bin(CTX_SAO_TYPE, typ != 0);
        if (typ != 0) cab.ep(typ == 2 ? 1 : 0);
      }
      if (typ == 0) continue;
      const int32_t* offs = c_idx == 0 ? &sao_off_y[idx * 4]
                          : (c_idx == 1 ? &sao_off_cb[idx * 4]
                                        : &sao_off_cr[idx * 4]);
      int cls = c_idx == 0 ? sao_class_y[idx]
              : (c_idx == 1 ? sao_class_cb[idx] : sao_class_cr[idx]);
      for (int i = 0; i < 4; i++) write_tr_offset(abs(offs[i]), max_off);
      if (typ == 1) {                    // BO
        for (int i = 0; i < 4; i++)
          if (offs[i]) cab.ep(offs[i] < 0 ? 1 : 0);
        cab.eps(cls, 5);
      } else if (c_idx <= 1) {           // EO class
        cab.eps(cls, 2);
      }
    }
  }

  int chroma_qp(int qpy, int off) const {
    int bdo = 6 * (bd - 8);
    int q = clip3(-bdo, 57, qpy + off);
    if (q < 0) return q + bdo;
    return kChromaQp[q] + bdo;
  }

  void run() {
    w4 = (width + 3) >> 2; h4 = (height + 3) >> 2;
    avail4.assign(w4 * h4, 0);
    isintra4.resize(w4 * h4);
    mode4.resize(w4 * h4);
    depth4.resize(w4 * h4);
    skip4.resize(w4 * h4);
    mv4.resize(w4 * h4 * 4);
    ref4.resize(w4 * h4 * 2);
    int init_type = slice_type == 2 ? 0 : (slice_type == 1 ? 1 : 2);
    cab.init_slice(init_type, qp);

    int ctb = 1 << ctb_log2;
    int wc = (width + ctb - 1) / ctb, hc = (height + ctb - 1) / ctb;
    wc_ctbs = wc;
    int n_ctbs = wc * hc;
    int begin = ctb_begin;
    int end = ctb_count < 0 ? n_ctbs : ctb_begin + ctb_count;
    if (end > n_ctbs) end = n_ctbs;
    bool sao_on = (sao_luma || sao_chroma) && sao_type_y;
    qp_prev = qp;
    int slice_qp = qp;
    // WPP (entropy_coding_sync, 7.3.8.1 + 9.3.1): per-CTU-row byte-
    // aligned substreams; each row's contexts sync from the snapshot
    // taken after the second CTU of the row above (x265
    // entropy.cpp:724 / frameencoder.cpp:1033 serializeSubstreams)
    uint8_t wpp_snap[NUM_CONTEXTS];
    uint8_t wpp_init[NUM_CONTEXTS];
    bool have_snap = false;
    bool do_wpp = wpp && begin == 0;
    if (do_wpp) memcpy(wpp_init, cab.ctx, NUM_CONTEXTS);
    size_t ss_prev = 0;
    n_ss = 0;
    for (int addr = begin; addr < end; addr++) {
      int col = addr % wc;
      int x0 = col * ctb, y0 = (addr / wc) * ctb;
      if (do_wpp && col == 0 && addr != begin) {
        // row start: fresh arithmetic engine + context handoff
        cab.low = 0; cab.range = 510; cab.bits_left = 23;
        cab.num_buffered = 0; cab.buffered_byte = 0xFF;
        memcpy(cab.ctx, (wc > 1 && have_snap) ? wpp_snap : wpp_init,
               NUM_CONTEXTS);
        qp_prev = slice_qp;     // 8.6.1: qPY_PREV resets per CTB row
      }
      if (qp_map) {
        qg_wanted = qp_map[addr];
        qg_coded = false;
        qp = qg_wanted;                 // quantize with the target QP
      }
      if (sao_on) write_sao(addr / wc, addr % wc, addr - begin < wc);
      quadtree(x0, y0, ctb_log2, 0);
      if (do_wpp && col == 1) {
        memcpy(wpp_snap, cab.ctx, NUM_CONTEXTS);
        have_snap = true;
      }
      if (qp_map)   // qPY_PREV for the next QG = last CU's QpY
        qp_prev = qg_coded ? qg_wanted : qp_prev;
      cab.trm(addr == end - 1 ? 1 : 0);
      if (do_wpp && col == wc - 1 && addr != end - 1) {
        cab.trm(1);               // end_of_subset_one_bit
        cab.finish();             // flush + byte alignment
        if (ss_sizes && n_ss < ss_cap)
          ss_sizes[n_ss] = (int32_t)(cab.out.size() - ss_prev);
        n_ss++;
        ss_prev = cab.out.size();
      }
    }
    qp = slice_qp;
    cab.finish();
    if (do_wpp) {
      if (ss_sizes && n_ss < ss_cap)
        ss_sizes[n_ss] = (int32_t)(cab.out.size() - ss_prev);
      n_ss++;
    }
  }

  void quadtree(int x0, int y0, int log2_cb, int depth) {
    int size = 1 << log2_cb;
    bool inside = x0 + size <= width && y0 + size <= height;
    bool split;
    if (inside && log2_cb > min_cb_log2) {
      int ctxi = 0;
      if (x0 > 0 && avail4[(y0 >> 2) * w4 + ((x0 - 1) >> 2)])
        ctxi += depth4[(y0 >> 2) * w4 + ((x0 - 1) >> 2)] > depth;
      if (y0 > 0 && avail4[((y0 - 1) >> 2) * w4 + (x0 >> 2)])
        ctxi += depth4[((y0 - 1) >> 2) * w4 + (x0 >> 2)] > depth;
      split = cu_log2_map[(y0 >> 3) * w8 + (x0 >> 3)] < log2_cb;
      cab.bin(CTX_SPLIT_CU + ctxi, split);
    } else {
      split = log2_cb > min_cb_log2;
    }
    if (split) {
      int half = size >> 1;
      static const int off[4][2] = {{0, 0}, {1, 0}, {0, 1}, {1, 1}};
      for (auto& o : off) {
        int x1 = x0 + o[0] * half, y1 = y0 + o[1] * half;
        if (x1 < width && y1 < height) quadtree(x1, y1, log2_cb - 1, depth + 1);
      }
    } else {
      coding_unit(x0, y0, log2_cb, depth);
      // per-CU QpY (8.6.1): pre-delta CUs keep the prediction; without
      // a QP map every CU has the slice QP
      int cuqp = !qp_map ? qp : (qg_coded ? qg_wanted : qp_prev);
      for (int yy = y0 >> 2; yy < (y0 + size) >> 2 && yy < h4; yy++)
        for (int xx = x0 >> 2; xx < (x0 + size) >> 2 && xx < w4; xx++)
          qp_actual[yy * w4 + xx] = cuqp;
    }
  }

  void mpm(int xpb, int ypb, int* cands) const {
    auto nb = [&](int x, int yy) -> int {
      if (x < 0 || yy < 0) return 1;
      int idx = (yy >> 2) * w4 + (x >> 2);
      if (!avail4[idx] || !isintra4[idx]) return 1;
      return mode4[idx];
    };
    int a = nb(xpb - 1, ypb);
    int b = (ypb % (1 << ctb_log2)) == 0 ? 1 : nb(xpb, ypb - 1);
    if (a == b) {
      if (a < 2) { cands[0] = 0; cands[1] = 1; cands[2] = 26; }
      else {
        cands[0] = a;
        cands[1] = 2 + ((a + 29) % 32);
        cands[2] = 2 + ((a - 2 + 1) % 32);
      }
    } else {
      cands[0] = a; cands[1] = b;
      if (a != 0 && b != 0) cands[2] = 0;
      else if (a != 1 && b != 1) cands[2] = 1;
      else cands[2] = 26;
    }
  }

  // --- inter helpers ---

  bool neighbor_motion(int x, int yy, Motion* m) const {
    if (x < 0 || yy < 0 || x >= width || yy >= height) return false;
    int idx = (yy >> 2) * w4 + (x >> 2);
    if (!avail4[idx]) return false;
    int r0 = ref4[idx * 2], r1 = ref4[idx * 2 + 1];
    if (r0 < 0 && r1 < 0) return false;
    m->dir = (r0 >= 0 ? 1 : 0) | (r1 >= 0 ? 2 : 0);
    for (int l = 0; l < 2; l++) {
      m->mv[l][0] = mv4[idx * 4 + l * 2];
      m->mv[l][1] = mv4[idx * 4 + l * 2 + 1];
    }
    m->ref[0] = r0; m->ref[1] = r1;
    return true;
  }

  bool no_backward_pred() const {
    for (int l = 0; l < 2; l++)
      for (int r = 0; r < nref[l]; r++)
        if (ref_poc[l][r] > cur_poc) return false;
    return true;
  }

  // Temporal luma MV for list lx targeting target_poc (8.5.3.2.7):
  // bottom-right C0 (same CTU row) then center C1; col list choice per
  // 8.5.3.2.9; scaled per 8.5.3.2.8.
  bool temporal_mv(int x0, int y0, int nw, int nh, int lx, int target_poc,
                   bool no_backward, int* omv) const {
    if (!col_dir) return false;
    int w16 = (width + 15) >> 4, h16 = (height + 15) >> 4;
    int ctb = 1 << ctb_log2;
    int pos[2][2];
    int np = 0;
    int xbr = x0 + nw, ybr = y0 + nh;
    if (xbr < width && ybr < height && (ybr / ctb) == (y0 / ctb)) {
      pos[np][0] = xbr; pos[np][1] = ybr; np++;
    }
    pos[np][0] = x0 + (nw >> 1); pos[np][1] = y0 + (nh >> 1); np++;
    for (int k = 0; k < np; k++) {
      int i = pos[k][1] >> 4, j = pos[k][0] >> 4;
      if (i >= h16 || j >= w16) continue;
      int d = col_dir[i * w16 + j];
      if (d == 0) continue;
      int ly;
      if (d == 1) ly = 0;
      else if (d == 2) ly = 1;
      else if (no_backward) ly = lx;
      else ly = col_from_l0;
      int mvx = col_mv[(i * w16 + j) * 4 + ly * 2];
      int mvy = col_mv[(i * w16 + j) * 4 + ly * 2 + 1];
      int tb = cur_poc - target_poc;
      int td = col_poc - col_refpoc[(i * w16 + j) * 2 + ly];
      scale_mv(mvx, mvy, tb, td, &omv[0], &omv[1]);
      return true;
    }
    return false;
  }

  int merge_list(int x0, int y0, int nw, int nh, Motion* out) const {
    Motion nb[5];
    bool ok[5];
    ok[0] = neighbor_motion(x0 - 1, y0 + nh - 1, &nb[0]);      // A1
    ok[1] = neighbor_motion(x0 + nw - 1, y0 - 1, &nb[1]);      // B1
    ok[2] = neighbor_motion(x0 + nw, y0 - 1, &nb[2]);          // B0
    ok[3] = neighbor_motion(x0 - 1, y0 + nh, &nb[3]);          // A0
    ok[4] = neighbor_motion(x0 - 1, y0 - 1, &nb[4]);           // B2
    int n = 0;
    if (ok[0]) out[n++] = nb[0];
    if (ok[1] && !(ok[0] && same_motion(nb[1], nb[0]))) out[n++] = nb[1];
    if (ok[2] && !(ok[1] && same_motion(nb[2], nb[1]))) out[n++] = nb[2];
    if (ok[3] && !(ok[0] && same_motion(nb[3], nb[0]))) out[n++] = nb[3];
    if (n < 4 && ok[4] && !(ok[0] && same_motion(nb[4], nb[0])) &&
        !(ok[1] && same_motion(nb[4], nb[1])))
      out[n++] = nb[4];
    bool is_b = slice_type == 0;
    // temporal candidate (refIdx 0, no pruning vs spatial)
    if (col_dir && n < max_merge) {
      bool nb_flag = no_backward_pred();
      int mv0[2], mv1[2];
      bool h0 = temporal_mv(x0, y0, nw, nh, 0, ref_poc[0][0], nb_flag, mv0);
      bool h1 = is_b && nref[1] > 0 &&
                temporal_mv(x0, y0, nw, nh, 1, ref_poc[1][0], nb_flag, mv1);
      if (h0 || h1) {
        Motion c;
        c.dir = (h0 ? 1 : 0) | (h1 ? 2 : 0);
        if (h0) { c.mv[0][0] = mv0[0]; c.mv[0][1] = mv0[1]; c.ref[0] = 0; }
        if (h1) { c.mv[1][0] = mv1[0]; c.mv[1][1] = mv1[1]; c.ref[1] = 0; }
        out[n++] = c;
      }
    }
    if (is_b && n > 1 && n < max_merge) {
      int n_orig = n;
      for (auto& pr : kCombPairs) {
        if (n >= max_merge) break;
        int i = pr[0], j = pr[1];
        if (i >= n_orig || j >= n_orig) continue;
        if (!(out[i].dir & 1) || !(out[j].dir & 2)) continue;
        int poc0 = ref_poc[0][out[i].ref[0]];
        int poc1 = ref_poc[1][out[j].ref[1]];
        if (poc0 != poc1 || out[i].mv[0][0] != out[j].mv[1][0] ||
            out[i].mv[0][1] != out[j].mv[1][1]) {
          Motion c;
          c.dir = 3;
          c.mv[0][0] = out[i].mv[0][0]; c.mv[0][1] = out[i].mv[0][1];
          c.mv[1][0] = out[j].mv[1][0]; c.mv[1][1] = out[j].mv[1][1];
          c.ref[0] = out[i].ref[0]; c.ref[1] = out[j].ref[1];
          out[n++] = c;
        }
      }
    }
    int nz = is_b ? std::min(nref[0], nref[1]) : nref[0];
    int zi = 0;
    while (n < max_merge) {
      Motion z;
      int r = zi < nz ? zi : 0;
      if (is_b) { z.dir = 3; z.ref[0] = z.ref[1] = r; }
      else { z.dir = 1; z.ref[0] = r; }
      out[n++] = z;
      zi++;
    }
    return max_merge;
  }

  // first-pass: neighbor motion whose ref pic IS the target (lx then 1-lx)
  bool cand_same_poc(const Motion& m, int lx, int target_poc, int* mv) const {
    for (int pass = 0; pass < 2; pass++) {
      int ly = pass == 0 ? lx : 1 - lx;
      if ((m.dir & (1 << ly)) && m.ref[ly] >= 0 && m.ref[ly] < nref[ly] &&
          ref_poc[ly][m.ref[ly]] == target_poc) {
        mv[0] = m.mv[ly][0]; mv[1] = m.mv[ly][1];
        return true;
      }
    }
    return false;
  }
  bool cand_scaled(const Motion& m, int lx, int target_poc, int* mv) const {
    for (int pass = 0; pass < 2; pass++) {
      int ly = pass == 0 ? lx : 1 - lx;
      if ((m.dir & (1 << ly)) && m.ref[ly] >= 0 && m.ref[ly] < nref[ly]) {
        int tb = cur_poc - target_poc;
        int td = cur_poc - ref_poc[ly][m.ref[ly]];
        scale_mv(m.mv[ly][0], m.mv[ly][1], tb, td, &mv[0], &mv[1]);
        return true;
      }
    }
    return false;
  }

  void amvp(int x0, int y0, int nw, int nh, int lx, int rid,
            int amvp_out[2][2]) const {
    int target_poc = ref_poc[lx][rid];
    Motion a0, a1, b0, b1, b2;
    bool ok_a0 = neighbor_motion(x0 - 1, y0 + nh, &a0);
    bool ok_a1 = neighbor_motion(x0 - 1, y0 + nh - 1, &a1);
    bool ok_b0 = neighbor_motion(x0 + nw, y0 - 1, &b0);
    bool ok_b1 = neighbor_motion(x0 + nw - 1, y0 - 1, &b1);
    bool ok_b2 = neighbor_motion(x0 - 1, y0 - 1, &b2);
    bool is_scaled = ok_a0 || ok_a1;

    int mva[2], mvb[2];
    bool have_a = false, have_b = false;
    const Motion* As[2] = {&a0, &a1};
    bool okA[2] = {ok_a0, ok_a1};
    for (int k = 0; k < 2 && !have_a; k++)
      if (okA[k]) have_a = cand_same_poc(*As[k], lx, target_poc, mva);
    for (int k = 0; k < 2 && !have_a; k++)
      if (okA[k]) have_a = cand_scaled(*As[k], lx, target_poc, mva);

    const Motion* Bs[3] = {&b0, &b1, &b2};
    bool okB[3] = {ok_b0, ok_b1, ok_b2};
    for (int k = 0; k < 3 && !have_b; k++)
      if (okB[k]) have_b = cand_same_poc(*Bs[k], lx, target_poc, mvb);

    if (!is_scaled) {
      // steps 6-7: promote B's same-poc result into A, re-derive B scaled
      have_a = have_b;
      if (have_b) { mva[0] = mvb[0]; mva[1] = mvb[1]; }
      have_b = false;
      for (int k = 0; k < 3 && !have_b; k++)
        if (okB[k]) have_b = cand_scaled(*Bs[k], lx, target_poc, mvb);
    }

    int n = 0;
    if (have_a) { amvp_out[n][0] = mva[0]; amvp_out[n][1] = mva[1]; n++; }
    if (have_b && !(have_a && mvb[0] == mva[0] && mvb[1] == mva[1])) {
      amvp_out[n][0] = mvb[0]; amvp_out[n][1] = mvb[1]; n++;
    }
    if (n < 2 && col_dir) {
      int mvt[2];
      if (temporal_mv(x0, y0, nw, nh, lx, target_poc, no_backward_pred(),
                      mvt)) {
        amvp_out[n][0] = mvt[0]; amvp_out[n][1] = mvt[1]; n++;
      }
    }
    for (; n < 2; n++) { amvp_out[n][0] = 0; amvp_out[n][1] = 0; }
  }

  void encode_skip_flag(int x0, int y0, int val) {
    int ctxi = 0;
    if (x0 > 0 && avail4[(y0 >> 2) * w4 + ((x0 - 1) >> 2)])
      ctxi += skip4[(y0 >> 2) * w4 + ((x0 - 1) >> 2)] ? 1 : 0;
    if (y0 > 0 && avail4[((y0 - 1) >> 2) * w4 + (x0 >> 2)])
      ctxi += skip4[((y0 - 1) >> 2) * w4 + (x0 >> 2)] ? 1 : 0;
    cab.bin(CTX_CU_SKIP + ctxi, val);
  }

  void encode_merge_idx(int idx) {
    int cmax = max_merge - 1;
    if (cmax == 0) return;
    cab.bin(CTX_MERGE_IDX, idx > 0 ? 1 : 0);
    if (idx > 0) {
      for (int i = 1; i < idx; i++) cab.ep(1);
      if (idx < cmax) cab.ep(0);
    }
  }

  void encode_mvd(int mvd_x, int mvd_y) {
    int ax = abs(mvd_x), ay = abs(mvd_y);
    cab.bin(CTX_MVD + 0, ax > 0);
    cab.bin(CTX_MVD + 0, ay > 0);
    if (ax > 0) cab.bin(CTX_MVD + 1, ax > 1);
    if (ay > 0) cab.bin(CTX_MVD + 1, ay > 1);
    auto eg1 = [&](int value) {
      int k = 1;
      while (value >= (1 << k)) { cab.ep(1); value -= 1 << k; k++; }
      cab.ep(0);
      for (int i = k - 1; i >= 0; i--) cab.ep((value >> i) & 1);
    };
    if (ax > 0) {
      if (ax > 1) eg1(ax - 2);
      cab.ep(mvd_x < 0 ? 1 : 0);
    }
    if (ay > 0) {
      if (ay > 1) eg1(ay - 2);
      cab.ep(mvd_y < 0 ? 1 : 0);
    }
  }

  // MC prediction for the CU, pixel domain, all three planes
  void mc_cu(int x0, int y0, int size, const Motion& m,
             int32_t* py, int32_t* pcb, int32_t* pcr) const {
    int hs = size >> 1;
    int strideL = width + 2 * pad_luma;
    int strideC = (width >> 1) + pad_luma;
    auto pred_plane = [&](int pl, int32_t* dst) {
      int n = pl == 0 ? size : hs;
      int xx = pl == 0 ? x0 : x0 >> 1;
      int yy = pl == 0 ? y0 : y0 >> 1;
      int stride = pl == 0 ? strideL : strideC;
      int padc = pl == 0 ? pad_luma : pad_luma >> 1;
      int fb = pl == 0 ? 2 : 3;
      int32_t t0[64 * 64], t1[64 * 64];
      if (m.dir == 3) {
        mc_14(refp[0][m.ref[0]][pl], stride, padc, xx, yy, n, n,
              m.mv[0][0], m.mv[0][1], fb, pl == 0, bd, t0);
        mc_14(refp[1][m.ref[1]][pl], stride, padc, xx, yy, n, n,
              m.mv[1][0], m.mv[1][1], fb, pl == 0, bd, t1);
        bipred_px(t0, t1, n * n, bd, dst);
      } else {
        int l = m.dir == 1 ? 0 : 1;
        mc_14(refp[l][m.ref[l]][pl], stride, padc, xx, yy, n, n,
              m.mv[l][0], m.mv[l][1], fb, pl == 0, bd, t0);
        const int32_t* wpe = (l == 0 && wp) ? wp + (m.ref[0] * 3 + pl) * 3
                                            : nullptr;
        if (wpe && wpe[0])
          weighted_unipred_px(t0, n * n, bd, wpe[1], wpe[2],
                              pl == 0 ? wp_ldenom : wp_cdenom, dst);
        else
          unipred_px(t0, n * n, bd, dst);
      }
    };
    pred_plane(0, py);
    pred_plane(1, pcb);
    pred_plane(2, pcr);
  }

  // transform+quant of (src - pred); returns cbf; fills levels + recon resi
  bool coeffs_from_pred(int pl, int x0, int y0, int n, const int32_t* pred,
                        int32_t* lvl, int32_t* rres) {
    int pw = pl == 0 ? width : width >> 1;
    const uint16_t* src = pl == 0 ? src_y : (pl == 1 ? src_cb : src_cr);
    int32_t resi[32 * 32];          // max inter TB is 32x32
    bool any = false;
    for (int j = 0; j < n; j++)
      for (int i = 0; i < n; i++) {
        resi[j * n + i] = src[(y0 + j) * pw + (x0 + i)] - pred[j * n + i];
        if (resi[j * n + i]) any = true;
      }
    if (lossless) {
      memcpy(lvl, resi, n * n * sizeof(int32_t));
      memcpy(rres, resi, n * n * sizeof(int32_t));
      return any;
    }
    int qpc = pl == 0 ? qp + 6 * (bd - 8)  // Qp'Y (8.6.1)
                      : chroma_qp(qp, pl == 1 ? cb_qp_off : cr_qp_off);
    int32_t cf[32 * 32];
    fwd_transform(resi, n, false, bd, cf);
    {
      int lg = 0; while ((1 << lg) < n) lg++;
      denoise(cf, n, lg, pl, false);
    }
    const int32_t* mtx = sm(n, false);
    quantize(cf, n, qpc, bd, lvl, /*is_intra=*/false, mtx);
    if (rdoq_level > 0)
      rdoq_adjust(cf, lvl, n, qpc, bd, mtx, rk(pl),
                  pl == 0 ? psy_fx : 0);
    bool nz = false;
    for (int i = 0; i < n * n; i++) if (lvl[i]) { nz = true; break; }
    if (nz && sign_hiding) {
      int log2 = 0; while ((1 << log2) < n) log2++;
      sbh_adjust(lvl, n, scan_tab(log2, 0));
      nz = false;
      for (int i = 0; i < n * n; i++) if (lvl[i]) { nz = true; break; }
    }
    memset(rres, 0, n * n * sizeof(int32_t));
    if (nz) {
      int32_t deq[32 * 32];
      dequantize(lvl, n, qpc, bd, deq, mtx);
      inv_transform(deq, n, false, bd, rres);
    }
    ts_flag[pl] = -1;
    if (n == 4 && tskip && !lossless) {
      ts_flag[pl] = try_tskip(resi, qpc, false, mtx,
                              scan_tab(2, 0), lvl, rres, rk(pl),
                              pl == 0 ? psy_fx : 0);
      nz = false;
      for (int i = 0; i < 16; i++) if (lvl[i]) { nz = true; break; }
    }
    return nz;
  }

  void finish_inter(int x0, int y0, int size, int depth, const Motion& m,
                    bool skip, bool cbf_y_set,
                    const int32_t* py, const int32_t* pcb, const int32_t* pcr,
                    const int32_t* ry, const int32_t* rcb, const int32_t* rcr) {
    int maxv = (1 << bd) - 1;
    int hs = size >> 1, cw = width >> 1;
    if (py) {       // null = precomputed: recon already in the planes
      for (int j = 0; j < size; j++)
        for (int i = 0; i < size; i++)
          y[(y0 + j) * width + (x0 + i)] = (int16_t)clip3(
              0, maxv, py[j * size + i] + (ry ? ry[j * size + i] : 0));
      for (int j = 0; j < hs; j++)
        for (int i = 0; i < hs; i++) {
          cb[((y0 >> 1) + j) * cw + ((x0 >> 1) + i)] = (int16_t)clip3(
              0, maxv, pcb[j * hs + i] + (rcb ? rcb[j * hs + i] : 0));
          cr[((y0 >> 1) + j) * cw + ((x0 >> 1) + i)] = (int16_t)clip3(
              0, maxv, pcr[j * hs + i] + (rcr ? rcr[j * hs + i] : 0));
        }
    }
    // the CU's 4x4-grid entries, a row of them at a time
    int32_t mv[4];
    int8_t ref[2];
    for (int l = 0; l < 2; l++) {
      bool used = (m.dir >> l) & 1;
      mv[l * 2] = used ? m.mv[l][0] : 0;
      mv[l * 2 + 1] = used ? m.mv[l][1] : 0;
      ref[l] = used ? (int8_t)m.ref[l] : -1;
    }
    int n4 = size >> 2;
    for (int yy = y0 >> 2; yy < (y0 + size) >> 2; yy++) {
      int row = yy * w4 + (x0 >> 2);
      for (int i = 0; i < n4; i++) {
        memcpy(&mv4[(row + i) * 4], mv, sizeof(mv));
        memcpy(&ref4[(row + i) * 2], ref, sizeof(ref));
      }
      memset(&skip4[row], skip, n4);
      memset(&cbf4[row], cbf_y_set, n4);
      memset(&depth4[row], depth, n4);
      memset(&isintra4[row], 0, n4);
      memset(&avail4[row], 1, n4);
    }
  }

  void inter_cu(int x0, int y0, int log2_cb, int depth) {
    int size = 1 << log2_cb;
    int hs = size >> 1;
    int b8 = (y0 >> 3) * w8 + (x0 >> 3);
    Motion m;
    m.dir = dir8[b8];
    int r0sel = ref8 ? ref8[b8] : 0;
    for (int l = 0; l < 2; l++) {
      bool used = (m.dir >> l) & 1;
      m.mv[l][0] = used ? mv8[b8 * 4 + l * 2] : 0;
      m.mv[l][1] = used ? mv8[b8 * 4 + l * 2 + 1] : 0;
      m.ref[l] = used ? (l == 0 ? r0sel : 0) : -1;
    }

    // 64x64 CU: log2TrafoSize 6 > MaxTbLog2SizeY 5 => the transform
    // tree splits implicitly into 4 32x32 luma TUs (+16x16 chroma),
    // with NO split_transform_flag bins (7.3.8.8; x265 analog:
    // Search::estimateResidualQT's first forced split, search.cpp:3178)
    bool cu64 = log2_cb == 6;
    // explicit RQT level for 16/32 CUs (device RD choice; x265
    // tuQTMaxInterDepth 2, search.cpp:2863)
    bool tusplit = !cu64 && log2_cb >= 4 && pre_tus8 &&
                   pre_tus8[(y0 >> 3) * w8 + (x0 >> 3)];
    bool split = cu64 || tusplit;
    int nq = split ? 4 : 1;
    int tn = cu64 ? 32 : (tusplit ? hs : size);  // luma TB size
    int tc = tn >> 1;                   // chroma TB size
    static const int qdx[4] = {0, 1, 0, 1}, qdy[4] = {0, 0, 1, 1};

    bool pre = pre_cu(x0, y0);
    if (!pre) n_host_cus++;
    // the CU's prediction and reconstructed residual, and where the
    // residual coder reads each TB's levels (read where its cbf is set):
    // written before they are read
    int32_t py[64 * 64], pcb[32 * 32], pcr[32 * 32];
    int32_t yres[64 * 64], cbres[32 * 32], crres[32 * 32];
    int16_t ylv[64 * 64], cblv[32 * 32], crlv[32 * 32];
    Lv ly[4], lcb[4], lcr[4];
    bool qy[4] = {0, 0, 0, 0}, qcb[4] = {0, 0, 0, 0}, qcr[4] = {0, 0, 0, 0};
    if (pre) {
      // device computed MC/transform/quant/recon — its levels + cbf
      for (int q = 0; q < nq; q++) {
        int qx0 = x0 + qdx[q] * tn, qy0 = y0 + qdy[q] * tn;
        uint8_t bits = pre_cbf8[(qy0 >> 3) * w8 + (qx0 >> 3)];
        qy[q] = bits & 1;
        qcb[q] = (bits >> 1) & 1;
        qcr[q] = (bits >> 2) & 1;
        ly[q] = pre_tb(0, qx0, qy0);
        lcb[q] = pre_tb(1, qx0 >> 1, qy0 >> 1);
        lcr[q] = pre_tb(2, qx0 >> 1, qy0 >> 1);
      }
    } else {
      if (!y) { bad = true; return; }   // no planes to reconstruct into
      mc_cu(x0, y0, size, m, py, pcb, pcr);
      int32_t predq[32 * 32], rresq[32 * 32], lvl[32 * 32];
      for (int q = 0; q < nq; q++) {
        int qx0 = x0 + qdx[q] * tn, qy0 = y0 + qdy[q] * tn;
        // luma quadrant
        for (int j = 0; j < tn; j++)
          for (int i = 0; i < tn; i++)
            predq[j * tn + i] =
                py[(qdy[q] * tn + j) * size + qdx[q] * tn + i];
        qy[q] = coeffs_from_pred(0, qx0, qy0, tn, predq, lvl, rresq);
        ly[q] = own_tb(lvl, tn, ylv + q * tn * tn);
        export_tb(0, qx0, qy0, tn, lvl, qy[q]);
        for (int j = 0; j < tn; j++)
          for (int i = 0; i < tn; i++)
            yres[(qdy[q] * tn + j) * size + qdx[q] * tn + i] =
                rresq[j * tn + i];
        // chroma quadrants
        for (int pl = 1; pl <= 2; pl++) {
          const int32_t* pc = pl == 1 ? pcb : pcr;
          int32_t* rc = pl == 1 ? cbres : crres;
          for (int j = 0; j < tc; j++)
            for (int i = 0; i < tc; i++)
              predq[j * tc + i] =
                  pc[(qdy[q] * tc + j) * hs + qdx[q] * tc + i];
          bool nz = coeffs_from_pred(pl, qx0 >> 1, qy0 >> 1, tc, predq, lvl,
                                     rresq);
          (pl == 1 ? qcb : qcr)[q] = nz;
          (pl == 1 ? lcb : lcr)[q] =
              own_tb(lvl, tc, (pl == 1 ? cblv : crlv) + q * tc * tc);
          export_tb(pl, qx0 >> 1, qy0 >> 1, tc, lvl, nz);
          for (int j = 0; j < tc; j++)
            for (int i = 0; i < tc; i++)
              rc[(qdy[q] * tc + j) * hs + qdx[q] * tc + i] =
                  rresq[j * tc + i];
        }
      }
    }
    bool cbf_y = qy[0] || qy[1] || qy[2] || qy[3];
    bool cbf_cb = qcb[0] || qcb[1] || qcb[2] || qcb[3];
    bool cbf_cr = qcr[0] || qcr[1] || qcr[2] || qcr[3];
    bool all_zero = !(cbf_y || cbf_cb || cbf_cr);

    // the CU's header. A collect walk codes no bin, so it leaves out the
    // merge and AMVP derivations, which only choose bins.
    bool skip = false;
    if (cab.enabled) {
      Motion cands[5];
      merge_list(x0, y0, size, size, cands);
      int merge_idx = -1;
      for (int i = 0; i < max_merge; i++)
        if (same_motion(cands[i], m)) { merge_idx = i; break; }
      skip = merge_idx >= 0 && all_zero;
      encode_skip_flag(x0, y0, skip ? 1 : 0);
      if (skip) {
        encode_merge_idx(merge_idx);
      } else {
        cab.bin(CTX_PRED_MODE, 0);
        cab.bin(CTX_PART_MODE, 1);       // 2Nx2N
        if (merge_idx >= 0) {
          cab.bin(CTX_MERGE_FLAG, 1);
          encode_merge_idx(merge_idx);
        } else {
          cab.bin(CTX_MERGE_FLAG, 0);
          if (slice_type == 0) {          // B: inter_pred_idc
            cab.bin(CTX_INTER_PRED_IDC + depth, m.dir == 3 ? 1 : 0);
            if (m.dir != 3)
              cab.bin(CTX_INTER_PRED_IDC + 4, m.dir == 1 ? 0 : 1);
          }
          for (int lx = 0; lx < 2; lx++) {
            if (!((m.dir >> lx) & 1)) continue;
            int rid = m.ref[lx];
            if (nref[lx] > 1) {        // ref_idx: TR, bins 0/1 ctx, rest ep
              cab.bin(CTX_REF_IDX, rid > 0 ? 1 : 0);
              if (rid > 0) {
                int cmax = nref[lx] - 1;
                for (int i = 1; i < cmax && i < rid; i++) {
                  if (i == 1) cab.bin(CTX_REF_IDX + 1, 1);
                  else cab.ep(1);
                }
                if (rid < cmax) {
                  if (rid == 1) cab.bin(CTX_REF_IDX + 1, 0);
                  else cab.ep(0);
                }
              }
            }
            int am[2][2];
            amvp(x0, y0, size, size, lx, rid, am);
            int c0 = abs(m.mv[lx][0] - am[0][0]) + abs(m.mv[lx][1] - am[0][1]);
            int c1 = abs(m.mv[lx][0] - am[1][0]) + abs(m.mv[lx][1] - am[1][1]);
            int mvp_idx = c0 <= c1 ? 0 : 1;
            encode_mvd(m.mv[lx][0] - am[mvp_idx][0],
                       m.mv[lx][1] - am[mvp_idx][1]);
            cab.bin(CTX_MVP_FLAG, mvp_idx);
          }
          cab.bin(CTX_RQT_ROOT_CBF, all_zero ? 0 : 1);
        }
      }
    }
    // the transform tree (a skipped CU and rqt_root_cbf 0 have none)
    if (!all_zero) {
      // split_transform_flag (7.3.8.8): present for inter CUs when the
      // SPS allows an explicit RQT level (ctxInc = 5 - log2TrafoSize)
      if (max_trafo_inter > 0 && !cu64 && log2_cb >= 3 && log2_cb <= 5)
        cab.bin(CTX_SPLIT_TRANSFORM + (5 - log2_cb), tusplit ? 1 : 0);
      if (!split) {
        cab.bin(CTX_CBF_CHROMA + 0, cbf_cb);
        cab.bin(CTX_CBF_CHROMA + 0, cbf_cr);
        if (cbf_cb || cbf_cr)
          cab.bin(CTX_CBF_LUMA + 1, cbf_y);
        // else cbf_luma inferred 1
        maybe_code_dqp(true);
        if (cbf_y)
          encode_residual(cab, ly[0].p, ly[0].stride, log2_cb, 0, 0,
                          sign_hiding, lossless);
        if (cbf_cb)
          encode_residual(cab, lcb[0].p, lcb[0].stride, log2_cb - 1, 1, 0,
                          sign_hiding, lossless,
                          log2_cb == 3 ? ts_flag[1] : -1);
        if (cbf_cr)
          encode_residual(cab, lcr[0].p, lcr[0].stride, log2_cb - 1, 2, 0,
                          sign_hiding, lossless,
                          log2_cb == 3 ? ts_flag[2] : -1);
      } else {
        // transform_tree at depth 0 (implicit split): hierarchical chroma
        // cbfs (ctxInc = trafoDepth, 9.3.4.2.2), then the 4 leaves in
        // z-order, each a transform_unit (cbf_luma ctx 0 at depth 1)
        int tnl2 = cu64 ? 5 : log2_cb - 1;
        cab.bin(CTX_CBF_CHROMA + 0, cbf_cb);
        cab.bin(CTX_CBF_CHROMA + 0, cbf_cr);
        for (int q = 0; q < 4; q++) {
          if (cbf_cb) cab.bin(CTX_CBF_CHROMA + 1, qcb[q]);
          if (cbf_cr) cab.bin(CTX_CBF_CHROMA + 1, qcr[q]);
          cab.bin(CTX_CBF_LUMA + 0, qy[q]);
          if (qy[q] || qcb[q] || qcr[q]) {
            maybe_code_dqp(true);
            if (qy[q])
              encode_residual(cab, ly[q].p, ly[q].stride, tnl2, 0, 0,
                              sign_hiding, lossless);
            if (qcb[q])
              encode_residual(cab, lcb[q].p, lcb[q].stride, tnl2 - 1, 1, 0,
                              sign_hiding, lossless);
            if (qcr[q])
              encode_residual(cab, lcr[q].p, lcr[q].stride, tnl2 - 1, 2, 0,
                              sign_hiding, lossless);
          }
        }
      }
    }
    // the recon (all-zero residuals where no cbf is set) and the maps
    finish_inter(x0, y0, size, depth, m, skip, cbf_y,
                 pre ? nullptr : py, pcb, pcr,
                 pre ? nullptr : yres, cbres, crres);
    if (split) {
      // per-quadrant luma cbf for the deblock maps (TU != CU here)
      for (int q = 0; q < 4; q++) {
        int qx0 = x0 + qdx[q] * tn, qy0 = y0 + qdy[q] * tn;
        for (int yy = qy0 >> 2; yy < (qy0 + tn) >> 2; yy++)
          memset(&cbf4[yy * w4 + (qx0 >> 2)], qy[q] ? 1 : 0, tn >> 2);
      }
    }
  }

  void coding_unit(int x0, int y0, int log2_cb, int depth) {
    int size = 1 << log2_cb;
    n_cus++;
    // cu_transquant_bypass_flag present iff PPS bypass enabled
    // (our PPS enables it exactly when the encode is lossless)
    if (lossless) cab.bin(CTX_CU_TRANSQUANT_BYPASS, 1);
    if (slice_type != 2) {
      bool is_inter = inter8 && inter8[(y0 >> 3) * w8 + (x0 >> 3)];
      if (is_inter) {
        inter_cu(x0, y0, log2_cb, depth);
        return;
      }
      encode_skip_flag(x0, y0, 0);
      cab.bin(CTX_PRED_MODE, 1);     // intra
    }
    // intra transform tree is TU==CU here: a 64x64 intra CU would need
    // an implicit RQT split transform_leaf does not implement, and its
    // fixed-size buffers would overflow (heap corruption, VERDICT r4
    // weak #2). Fail the slice instead; the caller falls back.
    if (log2_cb > 5) { bad = true; return; }
    if (log2_cb == min_cb_log2) cab.bin(CTX_PART_MODE, 1);  // 2Nx2N

    int mode = luma_mode8[(y0 >> 3) * w8 + (x0 >> 3)];
    int cands[3];
    mpm(x0, y0, cands);
    int idx = -1;
    for (int i = 0; i < 3; i++)
      if (cands[i] == mode) idx = i;
    if (idx >= 0) {
      cab.bin(CTX_PREV_INTRA_LUMA_PRED, 1);
      if (idx == 0) cab.ep(0);
      else { cab.ep(1); cab.ep(idx - 1); }
    } else {
      cab.bin(CTX_PREV_INTRA_LUMA_PRED, 0);
      int s[3] = {cands[0], cands[1], cands[2]};
      std::sort(s, s + 3);
      int rem = mode;
      for (int i = 2; i >= 0; i--)
        if (rem > s[i]) rem--;
      cab.eps(rem, 5);
    }
    for (int yy = y0 >> 2; yy < (y0 + size) >> 2; yy++)
      for (int xx = x0 >> 2; xx < (x0 + size) >> 2; xx++) {
        int idx = yy * w4 + xx;
        mode4[idx] = (int16_t)mode;
        isintra4[idx] = 1;
        depth4[idx] = (uint8_t)depth;
        skip4[idx] = 0;
        cbf4[idx] = 0;
        ref4[idx * 2] = ref4[idx * 2 + 1] = -1;
      }

    int chroma_mode = mode;
    if (chroma_mode8) {
      int cm = chroma_mode8[(y0 >> 3) * w8 + (x0 >> 3)];
      if (cm == mode) {
        cab.bin(CTX_INTRA_CHROMA_PRED, 0);
      } else {
        int cand[4] = {0, 26, 10, 1};
        for (int i = 0; i < 4; i++)
          if (cand[i] == mode) cand[i] = 34;
        int m = 0;
        for (int i = 0; i < 4; i++)
          if (cand[i] == cm) m = i;
        cab.bin(CTX_INTRA_CHROMA_PRED, 1);
        cab.eps(m, 2);
        chroma_mode = cm;
      }
    } else {
      cab.bin(CTX_INTRA_CHROMA_PRED, 0);
    }
    // one read of has8 for the CU's three TBs: a collect walk exports
    // the first before it codes the next
    bool pre = pre_cu(x0, y0);
    if (!pre) n_host_cus++;
    transform_leaf(x0, y0, log2_cb, mode, chroma_mode, pre);
  }

  // predict + residual/coeffs for one TB; returns cbf, fills recon and
  // says where its levels are (*lv; buf, nt x nt, holds computed ones)
  // plane: 0=y 1=cb 2=cr. pre: the CU is precomputed (its levels and cbf
  // are in the pre_* planes, its recon in the planes already)
  bool tb_process(int plane, int x0, int y0, int log2, int mode, bool pre,
                  int16_t* buf, Lv* lv) {
    int nt = 1 << log2;
    int pw = plane == 0 ? width : width >> 1;
    int ph = plane == 0 ? height : height >> 1;
    if (pre) {
      int b8 = plane == 0 ? ((y0 >> 3) * w8 + (x0 >> 3))
                          : ((y0 >> 2) * w8 + (x0 >> 2));
      *lv = pre_tb(plane, x0, y0);
      return (pre_cbf8[b8] >> plane) & 1;
    }
    int16_t* rec = plane == 0 ? y : (plane == 1 ? cb : cr);
    if (!rec) { bad = true; return false; }  // no planes to write
    const uint16_t* src = plane == 0 ? src_y : (plane == 1 ? src_cb : src_cr);
    int32_t ref[4 * 32 + 1], pred[32 * 32];  // max intra TB is 32x32
    if (plane == 0) {
      get_ref_samples(rec, pw, pw, ph, avail4.data(), w4, x0, y0, nt, bd, ref);
      filter_refs(ref, nt, mode, strong_smooth, bd);
      predict_intra(ref, nt, mode, 0, bd, pred);
    } else {
      // chroma availability = luma avail at (2x, 2y), read directly
      get_ref_samples(rec, pw, pw, ph, avail4.data(), w4, x0, y0, nt, bd,
                      ref, 1);
      predict_intra(ref, nt, mode, 1, bd, pred);
    }
    int32_t resi[32 * 32];
    bool any = false;
    for (int j = 0; j < nt; j++)
      for (int i = 0; i < nt; i++) {
        resi[j * nt + i] = src[(y0 + j) * pw + (x0 + i)] - pred[j * nt + i];
        if (resi[j * nt + i]) any = true;
      }
    int maxv = (1 << bd) - 1;
    if (lossless) {
      *lv = own_tb(resi, nt, buf);
      for (int j = 0; j < nt; j++)
        for (int i = 0; i < nt; i++)
          rec[(y0 + j) * pw + (x0 + i)] =
              (int16_t)clip3(0, maxv, pred[j * nt + i] + resi[j * nt + i]);
      export_tb(plane, x0, y0, nt, resi, any);
      return any;
    }
    int qpc = plane == 0 ? qp + 6 * (bd - 8)  // Qp'Y (8.6.1)
                         : chroma_qp(qp, plane == 1 ? cb_qp_off : cr_qp_off);
    bool use_dst = plane == 0 && log2 == 2;
    int32_t cf[32 * 32], lvl[32 * 32];
    fwd_transform(resi, nt, use_dst, bd, cf);
    denoise(cf, nt, log2, plane, true);
    const int32_t* mtx = sm(nt, true);
    quantize(cf, nt, qpc, bd, lvl, true, mtx);
    if (rdoq_level > 0)
      rdoq_adjust(cf, lvl, nt, qpc, bd, mtx, rk(plane),
                  plane == 0 ? psy_fx : 0);
    bool nz = false;
    for (int i = 0; i < nt * nt; i++) if (lvl[i]) { nz = true; break; }
    if (nz && sign_hiding) {
      int si = scan_index(log2, plane == 0 ? 0 : 1, mode, true);
      sbh_adjust(lvl, nt, scan_tab(log2, si));
      nz = false;
      for (int i = 0; i < nt * nt; i++) if (lvl[i]) { nz = true; break; }
    }
    int32_t rres[32 * 32];
    if (nz) {
      int32_t deq[32 * 32];
      dequantize(lvl, nt, qpc, bd, deq, mtx);
      inv_transform(deq, nt, use_dst, bd, rres);
    } else {
      memset(rres, 0, nt * nt * sizeof(int32_t));
    }
    ts_flag[plane] = -1;
    if (nt == 4 && tskip && !lossless) {
      int si = scan_index(2, plane == 0 ? 0 : 1, mode, true);
      ts_flag[plane] = try_tskip(resi, qpc, true, mtx, scan_tab(2, si), lvl,
                                 rres, rk(plane), plane == 0 ? psy_fx : 0);
      nz = false;
      for (int i = 0; i < 16; i++) if (lvl[i]) { nz = true; break; }
    }
    *lv = own_tb(lvl, nt, buf);
    for (int j = 0; j < nt; j++)
      for (int i = 0; i < nt; i++)
        rec[(y0 + j) * pw + (x0 + i)] =
            (int16_t)clip3(0, maxv, pred[j * nt + i] + rres[j * nt + i]);
    export_tb(plane, x0, y0, nt, lvl, nz);
    return nz;
  }

  void transform_leaf(int x0, int y0, int log2_tb, int mode, int chroma_mode,
                      bool pre) {
    int nt = 1 << log2_tb;
    int16_t ybuf[32 * 32], cbbuf[16 * 16], crbuf[16 * 16];
    Lv ly, lcb, lcr;
    // chroma first (cbf_cb/cr precede cbf_luma), matching python writer order
    bool cbf_cb = tb_process(1, x0 >> 1, y0 >> 1, log2_tb - 1, chroma_mode,
                             pre, cbbuf, &lcb);
    bool cbf_cr = tb_process(2, x0 >> 1, y0 >> 1, log2_tb - 1, chroma_mode,
                             pre, crbuf, &lcr);
    bool cbf_y = tb_process(0, x0, y0, log2_tb, mode, pre, ybuf, &ly);
    // NOTE: tb_process also reconstructed; chroma recon done before luma is
    // fine (no cross-plane dependency; see python writer commentary)
    cab.bin(CTX_CBF_CHROMA + 0, cbf_cb);
    cab.bin(CTX_CBF_CHROMA + 0, cbf_cr);
    cab.bin(CTX_CBF_LUMA + 1, cbf_y);
    maybe_code_dqp(cbf_y || cbf_cb || cbf_cr);
    if (cbf_y) {
      int si = scan_index(log2_tb, 0, mode, true);
      encode_residual(cab, ly.p, ly.stride, log2_tb, 0, si, sign_hiding,
                      lossless);
    }
    if (cbf_cb) {
      int si = scan_index(log2_tb - 1, 1, chroma_mode, true);
      encode_residual(cab, lcb.p, lcb.stride, log2_tb - 1, 1, si, sign_hiding,
                      lossless, log2_tb == 3 ? ts_flag[1] : -1);
    }
    if (cbf_cr) {
      int si = scan_index(log2_tb - 1, 2, chroma_mode, true);
      encode_residual(cab, lcr.p, lcr.stride, log2_tb - 1, 2, si, sign_hiding,
                      lossless, log2_tb == 3 ? ts_flag[2] : -1);
    }
    for (int yy = y0 >> 2; yy < (y0 + nt) >> 2; yy++)
      for (int xx = x0 >> 2; xx < (x0 + nt) >> 2; xx++)
        avail4[yy * w4 + xx] = 1;
  }
};

// What a walk keeps between calls: the 4x4-grid maps and the CABAC
// output keep their storage, so a walk in steady state allocates nothing.
// One per encoder and slice band (bands walk on threads).
struct Scratch {
  std::vector<uint8_t> avail4, isintra4, depth4, skip4;
  std::vector<int16_t> mode4;
  std::vector<int32_t> mv4;
  std::vector<int8_t> ref4;
  std::vector<uint8_t> out;
  std::vector<uint8_t> cbf4;      // the maps of a walk that exports none
  std::vector<int32_t> qp4;
  void swap(Writer& w) {
    avail4.swap(w.avail4); isintra4.swap(w.isintra4);
    depth4.swap(w.depth4); skip4.swap(w.skip4); mode4.swap(w.mode4);
    mv4.swap(w.mv4); ref4.swap(w.ref4); out.swap(w.cab.out);
  }
};

}  // namespace

extern "C" {

void* writer_scratch_new() { return new Scratch(); }
void writer_scratch_free(void* s) { delete static_cast<Scratch*>(s); }
// the bytes of the scratch's last walk (encode_slice_px returns how many)
const uint8_t* writer_scratch_bytes(void* s) {
  return static_cast<Scratch*>(s)->out.data();
}

// returns number of slice-data bytes written to out, or -1 on error
int encode_slice_intra(const uint8_t* src_y8, const uint8_t* src_cb8,
                       const uint8_t* src_cr8, int width, int height,
                       const int32_t* cu_log2_map, const int32_t* luma_mode8,
                       const int32_t* chroma_mode8,  // may be NULL => DM
                       int ctb_log2, int min_cb_log2, int slice_qp,
                       int lossless, int sign_hiding, int strong_smooth,
                       int cb_qp_off, int cr_qp_off,
                       uint8_t* out, int out_cap,
                       int16_t* rec_y, int16_t* rec_cb, int16_t* rec_cr) {
  Writer w;
  w.width = width; w.height = height;
  w.ctb_log2 = ctb_log2; w.min_cb_log2 = min_cb_log2;
  w.qp = slice_qp; w.bd = 8;
  w.lossless = lossless != 0;
  w.sign_hiding = sign_hiding != 0;
  w.strong_smooth = strong_smooth != 0;
  w.cb_qp_off = cb_qp_off; w.cr_qp_off = cr_qp_off;
  std::vector<uint16_t> y16(width * height), cb16((width / 2) * (height / 2)),
      cr16((width / 2) * (height / 2));
  for (size_t i = 0; i < y16.size(); i++) y16[i] = src_y8[i];
  for (size_t i = 0; i < cb16.size(); i++) cb16[i] = src_cb8[i];
  for (size_t i = 0; i < cr16.size(); i++) cr16[i] = src_cr8[i];
  w.src_y = y16.data(); w.src_cb = cb16.data(); w.src_cr = cr16.data();
  w.cu_log2_map = cu_log2_map; w.luma_mode8 = luma_mode8;
  w.chroma_mode8 = chroma_mode8;
  w.w8 = width >> 3;
  int w4 = (width + 3) >> 2, h4 = (height + 3) >> 2;
  std::vector<int16_t> y(width * height), cb(cb16.size()), cr(cr16.size());
  std::vector<uint8_t> cbf4(w4 * h4);
  std::vector<int32_t> qp4(w4 * h4);
  w.y = y.data(); w.cb = cb.data(); w.cr = cr.data();
  w.cbf4 = cbf4.data(); w.qp_actual = qp4.data();
  w.run();
  if (w.bad || (int)w.cab.out.size() > out_cap) return -1;
  memcpy(out, w.cab.out.data(), w.cab.out.size());
  if (rec_y) memcpy(rec_y, y.data(), y.size() * sizeof(int16_t));
  if (rec_cb) memcpy(rec_cb, cb.data(), cb.size() * sizeof(int16_t));
  if (rec_cr) memcpy(rec_cr, cr.data(), cr.size() * sizeof(int16_t));
  return (int)w.cab.out.size();
}

// Unified entry: I/P/B slices. slice_type uses the HEVC syntax values
// (0=B, 1=P, 2=I). Reference planes are int16, edge-padded by pad_luma
// (luma) / pad_luma/2 (chroma) on every side; NULL lists are unused.
// Returns the number of slice-data bytes, at writer_scratch_bytes(scratch),
// or -1 on error. Works in place on the caller's planes:
// rec_y/cb/cr (int16, optional where every CU is precomputed): the
//   precomputed CUs' recon is there already, the walk writes the rest;
// cbf4_out (uint8 [h4*w4]), qp_actual_out (int32 [h4*w4]), optional:
//   every CU of the band writes its entries (the deblock's luma-cbf and
//   QP maps);
// pre_*: the precomputed CUs (has8 = 1); with collect_only the walk
//   codes no bin and exports the TBs it computes into these planes, so
//   that an emit-only walk replays every TB from them;
// cu_counts (int32 [2], optional): += the CUs walked and those of them
//   reconstructed here.
int encode_slice_px(const uint16_t* src_y, const uint16_t* src_cb,
                    const uint16_t* src_cr, int width, int height,
                    const int32_t* cu_log2_map, const int32_t* luma_mode8,
                    const int32_t* chroma_mode8,
                    const uint8_t* inter8, const int32_t* dir8,
                    const int32_t* mv8, const int32_t* ref8,
                    int slice_type, int max_merge_cand,
                    const int16_t* const* ref_planes,  // [2*4*3] list,ref,plane
                    const int32_t* ref_pocs,           // [2*4]
                    int nref0, int nref1,
                    int pad_luma, int cur_poc,
                    int ctb_log2, int min_cb_log2, int slice_qp,
                    int lossless, int sign_hiding, int strong_smooth,
                    int cb_qp_off, int cr_qp_off,
                    int sao_luma, int sao_chroma,
                    const int32_t* sao_type_y, const int32_t* sao_class_y,
                    const int32_t* sao_off_y, const int32_t* sao_type_c,
                    const int32_t* sao_class_cb, const int32_t* sao_class_cr,
                    const int32_t* sao_off_cb, const int32_t* sao_off_cr,
                    const int32_t* qp_map, int32_t* qp_actual_out,
                    int bit_depth, int rdoq_level, void* scratch,
                    int16_t* rec_y, int16_t* rec_cb, int16_t* rec_cr,
                    uint8_t* cbf4_out,
                    const int32_t* wp, int wp_ldenom, int wp_cdenom,
                    const int32_t* col_dir, const int32_t* col_mv,
                    const int32_t* col_refpoc, int col_poc,
                    int col_from_l0,
                    const uint16_t* nr_off, uint32_t* nr_sum,
                    uint32_t* nr_cnt, int ctb_begin, int ctb_count,
                    int16_t* pre_lvl_y, int16_t* pre_lvl_cb,
                    int16_t* pre_lvl_cr, uint8_t* pre_cbf8,
                    uint8_t* pre_has8, int collect_only,
                    int scaling_lists, int tskip_enabled,
                    const int32_t* rate_consts,
                    int wpp, int32_t* substream_sizes_out,
                    int substream_cap, int psy_rdoq_fx,
                    const uint8_t* pre_tus8, int max_trafo_inter,
                    int32_t* cu_counts) {
  if (!scratch || (collect_only && !pre_has8)) return -1;
  Scratch* sc = static_cast<Scratch*>(scratch);
  int n4 = ((width + 3) >> 2) * ((height + 3) >> 2);
  if (!cbf4_out) {
    sc->cbf4.resize(n4);
    cbf4_out = sc->cbf4.data();
  }
  if (!qp_actual_out) {
    sc->qp4.resize(n4);
    qp_actual_out = sc->qp4.data();
  }
  Writer w;
  w.width = width; w.height = height;
  w.ctb_log2 = ctb_log2; w.min_cb_log2 = min_cb_log2;
  w.qp = slice_qp; w.bd = bit_depth;
  w.lossless = lossless != 0;
  w.sign_hiding = sign_hiding != 0;
  w.strong_smooth = strong_smooth != 0;
  w.cb_qp_off = cb_qp_off; w.cr_qp_off = cr_qp_off;
  w.src_y = src_y; w.src_cb = src_cb; w.src_cr = src_cr;
  w.cu_log2_map = cu_log2_map; w.luma_mode8 = luma_mode8;
  w.chroma_mode8 = chroma_mode8;
  w.w8 = width >> 3;
  w.slice_type = slice_type;
  w.inter8 = inter8; w.dir8 = dir8; w.mv8 = mv8; w.ref8 = ref8;
  w.max_merge = max_merge_cand;
  w.pad_luma = pad_luma;
  w.nref[0] = nref0; w.nref[1] = nref1;
  for (int l = 0; l < 2; l++)
    for (int r = 0; r < 4; r++) {
      for (int pl = 0; pl < 3; pl++)
        w.refp[l][r][pl] = ref_planes
            ? ref_planes[(l * 4 + r) * 3 + pl] : nullptr;
      w.ref_poc[l][r] = ref_pocs ? ref_pocs[l * 4 + r] : 0;
    }
  w.cur_poc = cur_poc;
  w.sao_luma = sao_luma; w.sao_chroma = sao_chroma;
  w.sao_type_y = sao_type_y; w.sao_class_y = sao_class_y;
  w.sao_off_y = sao_off_y; w.sao_type_c = sao_type_c;
  w.sao_class_cb = sao_class_cb; w.sao_class_cr = sao_class_cr;
  w.sao_off_cb = sao_off_cb; w.sao_off_cr = sao_off_cr;
  w.qp_map = qp_map;
  w.rdoq_level = rdoq_level;
  w.rate_consts = rate_consts;
  w.wp = wp; w.wp_ldenom = wp_ldenom; w.wp_cdenom = wp_cdenom;
  w.col_dir = col_dir; w.col_mv = col_mv; w.col_refpoc = col_refpoc;
  w.col_poc = col_poc; w.col_from_l0 = col_from_l0;
  if (!lossless && nr_off && nr_sum && nr_cnt) {
    w.nr_off = nr_off; w.nr_sum = nr_sum; w.nr_cnt = nr_cnt;
  }
  w.ctb_begin = ctb_begin;
  w.ctb_count = ctb_count;
  w.scaling = scaling_lists;
  w.tskip = tskip_enabled;
  w.wpp = wpp;
  w.ss_sizes = substream_sizes_out;
  w.ss_cap = substream_cap;
  w.psy_fx = psy_rdoq_fx;
  w.pre_tus8 = pre_tus8;
  w.max_trafo_inter = max_trafo_inter;
  if (collect_only) {
    w.cab.enabled = false;
    w.collect = true;
  }
  if (pre_has8) {
    w.pre_lvl_y = pre_lvl_y; w.pre_lvl_cb = pre_lvl_cb;
    w.pre_lvl_cr = pre_lvl_cr; w.pre_cbf8 = pre_cbf8;
    w.pre_has8 = pre_has8;
  }
  w.y = rec_y; w.cb = rec_cb; w.cr = rec_cr;
  w.cbf4 = cbf4_out; w.qp_actual = qp_actual_out;
  sc->swap(w);
  w.run();
  sc->swap(w);
  if (cu_counts) {
    cu_counts[0] += w.n_cus;
    cu_counts[1] += w.n_host_cus;
  }
  return w.bad ? -1 : (int)sc->out.size();
}

// recon export for the closed loop (optional; call right after encode)
// -- omitted: recon is recomputed identically by the python reference when
//    needed; a get_recon API can be added with a persistent handle later.

}  // extern "C"

extern "C" {
// debug: transform+quant one block, return levels (for differential tests)
int debug_tq(const int32_t* resi, int n, int qp, int use_dst, int32_t* lvl_out) {
  std::vector<int32_t> cf(n * n);
  fwd_transform(resi, n, use_dst != 0, 8, cf.data());
  quantize(cf.data(), n, qp, 8, lvl_out);
  return 0;
}
}

extern "C" {
int debug_itq(const int32_t* lvl, int n, int qp, int use_dst, int32_t* resi_out) {
  std::vector<int32_t> deq(n * n);
  dequantize(lvl, n, qp, 8, deq.data());
  inv_transform(deq.data(), n, use_dst != 0, 8, resi_out);
  return 0;
}
int debug_pred(const int32_t* ref, int nt, int mode, int c_idx, int strong,
               int32_t* dst) {
  std::vector<int32_t> r(ref, ref + 4 * nt + 1);
  if (c_idx == 0) filter_refs(r.data(), nt, mode, strong != 0, 8);
  predict_intra(r.data(), nt, mode, c_idx, 8, dst);
  return 0;
}
}
