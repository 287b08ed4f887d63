"""The explicit inter RQT level's decision (x265 tu-inter-depth 2,
estimateResidualQT, search.cpp:2863), written plainly: one coding unit at
a time, costs in float64.

For a 16x16 or 32x32 inter CU the port codes its residual two ways, as
one TU and as four quadrant TUs, and keeps the split where

    32 * SSE_split + lambda * (bits_split + 8)  <  32 * SSE_one + lambda * bits_one

SSE: the squared residual errors after reconstruction, over luma and both
chroma planes. bits: each coded TB's estBit rate (``tb_bits``) summed
over the planes (a TB without a level costs nothing); the split pays 8
bins for the tree (4 more cbf_luma and up to 8 child chroma cbfs, net of
the shared flag). lambda = LAM32_FULL[QP'Y] / 2^15, in bits.

Departures from x265: x265 codes each quadrant with the live CABAC
contexts, can split again down to its depth, takes the real bits of
the cbf and split flags and lets chroma 4x4 TBs merge at the parent;
here one split level, estBit rates of per-plane average contexts at the
slice's initial states, a fixed 8-bin tree charge.
"""
from __future__ import annotations

import math

import torch

from encbench.reference.rdoq import CG0, CG1, LAM32_FULL, rate_fx

# The port forms each cost in float32 from exact integer sums (SSE below
# 2^24, Q15 rates): the three planes' SSE added (two roundings), the rate
# product and the final add, each off by at most 2^-24 of the cost. Two
# costs closer than RQT_TIE of the larger (a dozen such roundings, twice
# what the two can carry) may be a tie, and their split is not compared.
RQT_TIE = 7e-7


def tb_bits(level, k) -> float:
    """One TB's rate in bits: the significant 4x4 groups (raster order)
    pay CG1 and their coefficients' estBit rates, the empty groups before
    the last significant one CG0, those after it nothing; plus a last
    position of 2 (log2 n + 1) bits. A 4x4 TB is its one group, with no
    group flag."""
    lv = torch.as_tensor(level).to(torch.int64)
    n = lv.shape[-1]
    k = [int(v) for v in k]
    lastpos = 2.0 * (math.log2(n) + 1.0)
    if n == 4:
        return int(rate_fx(lv, k).sum()) / 32768.0 + lastpos
    groups = [lv[gy:gy + 4, gx:gx + 4] for gy in range(0, n, 4)
              for gx in range(0, n, 4)]
    nz = [bool((g != 0).any()) for g in groups]
    last = max((i for i, z in enumerate(nz) if z), default=-1)
    fx = 0
    for i, g in enumerate(groups):
        if nz[i]:
            fx += k[CG1] + int(rate_fx(g, k).sum())
        elif i <= last:
            fx += k[CG0]
    return fx / 32768.0 + lastpos


def quadrants(a):
    """The four n/2 x n/2 quadrants of [n, n], in z-order."""
    m = a.shape[-1] // 2
    return [a[:m, :m], a[:m, m:], a[m:, :m], a[m:, m:]]


def costs(res, one, split, qp_y: int, k_luma, k_chroma):
    """(cost of one TU, cost of the split) of one CU. res: the (y, cb, cr)
    residuals; one, split: each plane's (levels, reconstructed residual)
    coded as one TU / as four quadrants (in the CU's layout)."""
    lam = LAM32_FULL[qp_y] / 32768.0
    ks = (k_luma, k_chroma, k_chroma)

    def sse(plane, rec):
        e = torch.as_tensor(res[plane]).to(torch.int64) - \
            torch.as_tensor(rec).to(torch.int64)
        return float(int((e * e).sum()))

    def bits(lv, k):
        lv = torch.as_tensor(lv)
        return tb_bits(lv, k) if bool((lv != 0).any()) else 0.0

    sse_a = sum(sse(p, one[p][1]) for p in range(3))
    sse_b = sum(sse(p, split[p][1]) for p in range(3))
    bits_a = sum(bits(one[p][0], ks[p]) for p in range(3))
    bits_b = sum(bits(q, ks[p]) for p in range(3)
                 for q in quadrants(torch.as_tensor(split[p][0])))
    return 32.0 * sse_a + lam * bits_a, 32.0 * sse_b + lam * (bits_b + 8.0)


def split_decision(res, one, split, qp_y: int, k_luma, k_chroma):
    """(split, cost one, cost split): split where it costs less."""
    a, b = costs(res, one, split, qp_y, k_luma, k_chroma)
    return b < a, a, b
