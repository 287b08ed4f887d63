"""The port's rate-distortion optimised quantization, written plainly: one
transform block at a time, every cost an int64 in one fixed-point domain.

What it computes (the semantics ``ops/ref/transform.rdoq`` documents):
each coefficient keeps the cheapest of the levels {l, l-1, 0} (the first
of equal costs), with

    cost(l) = 32 * (c - sign * dequant(l))^2 + rate(l) - credit(l)

then every 4x4 coefficient group that holds a level is zeroed where
32 * (the distortion that zeroing adds) is below the rate it saves plus
the coded_sub_block_flag's (estBit model) or less one lambda (the
static model). dequant(l) = (l * 16 * levScale[qp % 6] << qp / 6) >>
(bit depth + log2 n - 5), without rounding. rate(l):

- the estBit model (``consts``, the plane's eight Q15 constants
  [SIG0, SIG1, GT1_0, GT1_1, GT2_0, GT2_1, CG0, CG1] of the slice's
  spec-initial CABAC states, ``rate_consts``): (lam * rate_fx(l)) >> 15
  with lam = LAM32_FULL[qp] << 2 * (15 - bit depth - log2 n);
- the static model (``consts`` None): LAM32[qp] << ... times the bin
  count 1 (l = 0), 3 (l = 1), 5 + 2 * floor(log2 l) (l > 1).

credit(l), psy-RDOQ (``psy_fx`` = round(psy-rdoq * 256), luma only, the
caller gates the plane): (psy_fx * 32 * dequant(l)) >> 8 on every AC
position, 0 on DC.

Departures from x265's Quant::rdoQuant (quant.cpp:610), all the port's:
x265 walks the coefficients in reverse scan order with the live context
of each sig/greater1/greater2 flag and the Rice parameter, searches the
best last significant position and prices each coded_sub_block_flag in
its own context; here the rates are per-plane averages of the contexts
at their spec-initial states for the slice's QP, no last position is
searched, the candidates are always {l, l-1, 0}, the group decision is
one pass, lambda is a fixed-point table (0.85 * 2^((qp-12)/3), times 0.4
for the static model) and the psy term credits the dequantised level
rather than x265's scaled reconstruction energy. Flat quantisation only
(no scaling lists); sign-bit hiding runs after, outside RDOQ.
"""
from __future__ import annotations

import math

import torch

from encbench.reference.tables import (CTX_CNT, CTX_OFF, DEQUANT_SCALES,
                                       ENTROPY_BITS, init_contexts)

LAM32 = [int(math.floor(0.4 * 0.85 * 2.0 ** ((q - 12) / 3.0) * 32 + 0.5))
         for q in range(70)]
LAM32_FULL = [int(math.floor(0.85 * 2.0 ** ((q - 12) / 3.0) * 32 + 0.5))
              for q in range(70)]
SIG0, SIG1, GT1_0, GT1_1, GT2_0, GT2_1, CG0, CG1 = range(8)
EP_BIT = 1 << 15


def rate_consts(slice_type: int, qp: int):
    """[[8] luma, [8] chroma] Q15 constants: for each flag value, the mean
    cost over the plane's contexts of that syntax element at their
    spec-initial states (slice_type 2 I, 1 P, 0 B; QP clipped to 0-51)."""
    init_type = 0 if slice_type == 2 else (1 if slice_type == 1 else 2)
    st = init_contexts(init_type, min(max(0, int(qp)), 51))

    def avg(name, b):
        off, cnt = CTX_OFF[name], CTX_CNT[name]
        return sum(int(ENTROPY_BITS[st[off + i] ^ b])
                   for i in range(cnt)) // cnt

    return [[avg(f"{e}_{plane}", b) for e in ("sig", "gt1", "gt2", "csbf")
             for b in (0, 1)] for plane in ("luma", "chroma")]


def _floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2 x) of each x >= 1, counted against powers of two."""
    return sum((x >= (1 << b)).to(torch.int64) for b in range(1, 40))


def rate_fx(level: torch.Tensor, k) -> torch.Tensor:
    """Q15 rate of each |level| under the estBit constants k: SIG0 (0),
    SIG1 + the sign's bit + GT1_0 (1), ... + GT1_1 + GT2_0 (2), ... +
    GT1_1 + GT2_1 + the remainder r = l - 3 (3 and up): r + 1 bins below
    3 (Rice prefix, k = 0), 4 + 2 floor(log2(r - 2)) above (EG0)."""
    l = level.abs().to(torch.int64)
    r = l - 3
    tail = torch.where(r < 3, r + 1,
                       4 + 2 * _floor_log2((r - 2).clamp(min=1)))
    coded = k[SIG1] + EP_BIT + torch.where(
        l == 1, k[GT1_0],
        k[GT1_1] + torch.where(l == 2, k[GT2_0], k[GT2_1] + (tail << 15)))
    return torch.where(l == 0, k[SIG0], coded)


def _bins(level: torch.Tensor) -> torch.Tensor:
    """The static model's bins: 1 (0), 3 (1), 5 + 2 floor(log2 l) (>1)."""
    l = level.abs().to(torch.int64)
    return torch.where(l == 0, 1, torch.where(
        l == 1, 3, 5 + 2 * _floor_log2(l.clamp(min=1))))


def rdoq_block(coeff, level, qp: int, n: int, bit_depth: int = 8,
               consts=None, psy_fx: int = 0) -> torch.Tensor:
    """The RDOQ levels of one n x n block. coeff: the forward transform's
    coefficients; level: the deadzone quantiser's levels (both [n, n]);
    consts: the plane's eight constants or None. Returns [n, n] int64."""
    log2 = n.bit_length() - 1
    per, rem = qp // 6, qp % 6
    shift = bit_depth + log2 - 5
    scale = 16 * int(DEQUANT_SCALES[rem])
    tr_shift = 15 - bit_depth - log2
    lam = (LAM32 if consts is None else LAM32_FULL)[qp] << (2 * tr_shift)
    k = None if consts is None else [int(v) for v in consts]
    c = torch.as_tensor(coeff).to(torch.int64).reshape(n, n)
    q = torch.as_tensor(level).to(torch.int64).reshape(n, n)
    sign = torch.sign(q)
    ac = torch.ones((n, n), dtype=torch.bool)
    ac[0, 0] = False

    def dequant(l):
        return (l * scale << per) >> shift

    def rate(l):
        if k is None:
            return lam * _bins(l)
        return (lam * rate_fx(l, k)) >> 15

    def credit(l):
        if not psy_fx:
            return torch.zeros_like(l)
        return torch.where(ac, (psy_fx * 32 * dequant(l)) >> 8, 0)

    def cost(l):
        e = c - sign * dequant(l)
        return 32 * e * e + rate(l) - credit(l)

    l0 = q.abs()
    best, best_cost = l0, cost(l0)
    for cand in ((l0 - 1).clamp(min=0), torch.zeros_like(l0)):
        cc = cost(cand)
        take = cc < best_cost
        best = torch.where(take, cand, best)
        best_cost = torch.where(take, cc, best_cost)
    out = sign * best

    # whole-group zeroing
    got = credit(out.abs())
    for gy in range(0, n, 4):
        for gx in range(0, n, 4):
            o = out[gy:gy + 4, gx:gx + 4]
            la = o.abs()
            if int(la.sum()) == 0:
                continue
            cg = c[gy:gy + 4, gx:gx + 4]
            e = cg - torch.sign(o) * dequant(la)
            added = int((cg * cg).sum()) - int((e * e).sum())
            saved = int(rate(la).sum()) - int(got[gy:gy + 4, gx:gx + 4].sum())
            if k is None:
                saved -= lam
            else:
                saved += (lam * (k[CG1] - k[CG0])) >> 15
            if 32 * added < saved:
                out[gy:gy + 4, gx:gx + 4] = 0
    return out
