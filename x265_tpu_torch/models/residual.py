"""Exact-integer residual pipeline on the device — the decide/emit split.

Device side of the finalizer split (reference analog: x265 separates
Analysis::compressCTU pixel math from encodeCTU bin emission,
frameencoder.cpp:1519 vs 1533; quant.cpp:397 transformNxN). Everything
here reproduces the native finalizer's integer arithmetic BIT-EXACTLY —
forward/inverse transform (spec 8.6 HM scaling), quant (171/85 deadzone),
sign-bit-hiding, dequant — so the CPU consumes (levels, cbf, recon)
tensors and emits CABAC bins only, with streams byte-identical to the
all-CPU path.

Kernels are batched over TUs of one static size; per-TU QP is a tensor.
The transforms' matrix products run in float64: CUDA has no integer
matmul, and every accumulator below is an integer under 2^31 (bounds in
the docstrings), far inside float64's 2^53 exact range, so the products
are exact whatever order the library sums in. The integer RDOQ
(_rdoq_x64) accumulates its costs in int64, which torch has on every
device, and so does the scaling-list dequant, as the JAX package's call
sites trace it under enable_x64. Everything else is int32.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from x265_tpu_torch.ops.ref.transform import DCT, DST4
from x265_tpu_torch.utils import profiling
from x265_tpu_torch.hevc.tables import (
    QUANT_SCALES, DEQUANT_SCALES, RDOQ_LAM32, RDOQ_LAM32_FULL, SCANS,
    default_scaling_matrix,
)


def _tmat(n: int, dst: bool) -> np.ndarray:
    return (DST4 if (dst and n == 4) else DCT[n]).astype(np.int32)


@lru_cache(maxsize=32)
def _default_m(n: int, is_intra: bool, device: str) -> torch.Tensor:
    """Default scaling matrix (spec 7.4.5 / Tables 7-5,7-6) as an [n,n]
    int32 tensor. Only the DEFAULT lists reach the device path
    (--scaling-list default; param coerces custom files)."""
    return torch.from_numpy(
        default_scaling_matrix(n, is_intra).astype(np.int32)).to(device)


@lru_cache(maxsize=64)
def _tmat_dev(n: int, dst: bool, device: str) -> torch.Tensor:
    return torch.from_numpy(_tmat(n, dst)).to(device=device,
                                              dtype=torch.float64)


@lru_cache(maxsize=64)
def _table_dev(name: str, device: str) -> torch.Tensor:
    tab = {"quant": QUANT_SCALES, "dequant": DEQUANT_SCALES,
           "lam": RDOQ_LAM32, "lam_full": RDOQ_LAM32_FULL}[name]
    dt = np.int64 if name.startswith("lam") else np.int32
    return torch.tensor(np.asarray(tab, dt), device=device)


def _rshift_round(x, s):
    """(x + (1 << (s-1))) >> s, arithmetic shift (s static int >= 1)."""
    return (x + (1 << (s - 1))) >> s


def _imatmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer matrix product of float64-held integers -> int32."""
    return torch.matmul(a, b).to(torch.int32)


def fwd_transform_b(resi: torch.Tensor, n: int, dst: bool,
                    bd: int) -> torch.Tensor:
    """Batched forward transform [N,n,n] int32 -> [N,n,n] int32.

    Bounds: stage-1 acc <= 32*90*2^(bd+1) < 2^31; stage-2 acc <=
    32*90*2^16 < 2^31.
    """
    t = _tmat_dev(n, dst, str(resi.device))
    log2 = n.bit_length() - 1
    s1 = log2 + bd - 9
    s2 = log2 + 6
    r = resi.to(torch.float64)
    # tmp[k][y] = sum_x t[k,x] * resi[y,x]
    tmp = _imatmul(t, r.transpose(1, 2))                    # [N,k,y]
    tmp = _rshift_round(tmp, s1)
    # coeff[ky][kx] = sum_y t[ky,y] * tmp[kx,y]
    out = _imatmul(t, tmp.to(torch.float64).transpose(1, 2))  # [N,a,k]
    return _rshift_round(out, s2)


def inv_transform_b(coeff: torch.Tensor, n: int, dst: bool,
                    bd: int) -> torch.Tensor:
    """Batched normative inverse transform, 16-bit inter-stage clamp.
    Bounds: acc <= 32*90*2^15 < 2^30."""
    t = _tmat_dev(n, dst, str(coeff.device))
    s2 = 20 - bd
    c = coeff.to(torch.float64)
    # tmp[y][kx] = sum_ky t[ky,y] * coeff[ky,kx]  >> 7, clip16
    tmp = _imatmul(t.t(), c)                                # [N,a,x]
    tmp = _rshift_round(tmp, 7).clamp(-32768, 32767)
    # resi[y][x] = sum_kx t[kx,x] * tmp[y,kx] >> s2, clip16
    out = _imatmul(tmp.to(torch.float64), t)                # [N,y,x]
    return _rshift_round(out, s2).clamp(-32768, 32767)


def quantize_b(coeff: torch.Tensor, qp: torch.Tensor, n: int,
               is_intra: bool, bd: int,
               scaling: bool = False) -> torch.Tensor:
    """Batched deadzone quant; qp [N] per-TU. Bounds: |c|*scale < 2^30,
    offset <= 171<<20 => sum < 2^31 — int32 exact. With scaling lists the
    per-position quant coefficient is quantScale[rem]*16/m (x265
    ScalingList quantCoef derivation; default m >= 16 keeps the bound)."""
    log2 = n.bit_length() - 1
    qp = qp.to(torch.int32)
    per = torch.div(qp, 6, rounding_mode="floor")
    rem = qp - per * 6
    tr_shift = 15 - bd - log2
    qbits = (14 + per + tr_shift)[:, None, None]
    scale = _table_dev("quant", str(coeff.device))[rem.long()][:, None, None]
    if scaling:
        m = _default_m(n, is_intra, str(coeff.device))
        scale = torch.div(scale * 16, m[None], rounding_mode="floor")
    offset = torch.full_like(qbits, 171 if is_intra else 85) << (qbits - 9)
    c = coeff.to(torch.int32)
    a = c.abs()
    v = ((a * scale + offset) >> qbits).clamp(max=32767)
    return torch.where(c < 0, -v, v)


def _deq_core(lvl, per, rem, bs, rounded: bool, m=None):
    """Shared dequant core without int64 on the flat path:
    (t*2^per + rnd) >> bs == t << (per-bs)              (per >= bs)
                          == (t + rnd') >> (bs-per)     (per < bs)
    with t = lvl*scale*16 (|t| <= 32767*1152 < 2^26). rnd' = 2^(bs-per-1)
    when `rounded` (normative dequant), else 0 (RDOQ's deq).

    m: optional [n,n] scaling matrix (int32 tensor) in place of the flat
    16, with per [N] and lvl [N,n,n]; that path is int64, as every call
    site of the JAX package traces it (with the default matrices its
    products stay below 2^31 all the same: tests/test_torch_scaling.py)."""
    table = _table_dev("dequant", str(lvl.device))[rem.long()]
    if m is None:
        scale = table * 16
        while scale.dim() < lvl.dim():
            scale = scale[..., None]
            per = per[..., None]
        t = lvl.to(torch.int32) * scale
    else:
        scale = table.to(torch.int64)[..., None, None] * m.to(torch.int64)
        per = per[..., None, None]
        t = lvl.to(torch.int64) * scale
    sh = per - bs
    up = t << sh.clamp(min=0)
    dn_s = (-sh).clamp(min=0).to(t.dtype)
    if rounded:
        one = torch.ones_like(dn_s)
        rnd = torch.where(dn_s > 0, one << (dn_s - 1).clamp(min=0),
                          torch.zeros_like(dn_s))
    else:
        rnd = 0
    dn = (t + rnd) >> dn_s
    return torch.where(sh >= 0, up, dn)


def dequantize_b(lvl: torch.Tensor, qp: torch.Tensor, n: int,
                 bd: int, scaling: bool = False,
                 is_intra: bool = False) -> torch.Tensor:
    """Batched normative dequant + clamp16 (int32-only on the flat path;
    int64 on the scaling-list path)."""
    log2 = n.bit_length() - 1
    qp = qp.to(torch.int32)
    per = torch.div(qp, 6, rounding_mode="floor")
    m = _default_m(n, is_intra, str(lvl.device)) if scaling else None
    d = _deq_core(lvl, per, qp - per * 6, bd + log2 - 5, rounded=True, m=m)
    return d.clamp(-32768, 32767).to(torch.int32)


def _ilog2(l: torch.Tensor) -> torch.Tensor:
    """floor(log2(l)) for l >= 1, exact (threshold-count form)."""
    lg = torch.zeros_like(l)
    for k in range(1, 16):
        lg = lg + (l >= (1 << k)).to(l.dtype)
    return lg


@profiling.spanned("rdoq")
def _rdoq_x64(coeff, lvl, qp, n, bd, scaling: bool = False,
              is_intra: bool = False, consts=None, psy_fx: int = 0):
    """int64 body of rdoq_b (the JAX package traces it under x64; torch
    has int64 on every device, so nothing is switched here). Every call
    is a stage scope `rdoq` and adds its TBs to the counter `rdoq.tbs`.

    consts: optional [8] int32 Q15 fractional-bit constants
    (hevc.rate_model estBit analog) for the batch's plane; None keeps
    the static bin-count model.

    psy_fx: Q8 psy-rdoq strength — AC coefficients earn an energy
    credit (psy_fx * 32 * |dequant(l)|) >> 8 (quant.cpp:610 psy path,
    luma only; matches ops/ref/transform.rdoq bit-exactly)."""
    profiling.count("rdoq.tbs", coeff.shape[0])
    log2 = n.bit_length() - 1
    qp = qp.to(torch.int32)
    per = torch.div(qp, 6, rounding_mode="floor")
    rem = qp - per * 6
    bs = bd + log2 - 5
    tr_shift = 15 - bd - log2
    dev = str(coeff.device)
    # estBit path: real fractional bits get the full lambda2; the
    # static bin-count model keeps its 0.4-calibrated table
    lam_tab = _table_dev("lam" if consts is None else "lam_full", dev)
    lam_fx = (lam_tab[qp.long()] << (2 * tr_shift))[:, None, None]
    c = coeff.to(torch.int64)
    sgn = torch.sign(lvl).to(torch.int64)
    l0 = lvl.abs().to(torch.int64)
    m = _default_m(n, is_intra, dev) if scaling else None

    def deq(l):
        return _deq_core(l.to(torch.int32), per, rem, bs,
                         rounded=False, m=m).to(torch.int64)

    if consts is not None:
        K = consts.to(device=coeff.device, dtype=torch.int64)

        def rcost(l):
            # shared estBit formula (hevc/rate_model.py module doc)
            esc = (l - 5).clamp(min=1)
            lg = _ilog2(esc)
            remb = torch.where(l < 6, (l - 2).clamp(min=0) << 15,
                               (4 + 2 * lg) << 15)
            rf = torch.where(
                l == 0, K[0],
                K[1] + 32768 + torch.where(
                    l == 1, K[2],
                    K[3] + torch.where(l == 2, K[4], K[5] + remb)))
            return (lam_fx * rf) >> 15

        cg_gain = K[7] - K[6]
    else:
        def rcost(l):
            r = torch.where(l > 0, 3, 1).to(torch.int64)
            lg = _ilog2(l.clamp(min=1))
            return lam_fx * (r + torch.where(l > 1, 2 + 2 * lg,
                                             torch.zeros_like(lg)))

    if psy_fx:
        ac = torch.ones((1, n, n), dtype=torch.bool, device=coeff.device)
        ac[0, 0, 0] = False

        def credit(l):
            return torch.where(ac, (psy_fx * 32 * deq(l)) >> 8,
                               torch.zeros_like(l))
    else:
        def credit(l):
            return 0

    def cost(l):
        e = c - sgn * deq(l)
        return 32 * e * e + rcost(l) - credit(l)

    best_l = l0
    best = cost(l0)
    for cand in ((l0 - 1).clamp(min=0), torch.zeros_like(l0)):
        cc = cost(cand)
        take = cc < best
        best = torch.where(take, cc, best)
        best_l = torch.where(take, cand, best_l)
    out = sgn * best_l

    # CG zeroing: 32*(d_zero - d_now) < rate saved by coding csbf=0
    ncg = n // 4
    l_abs = out.abs()
    e_now = c - torch.sign(out) * deq(l_abs)

    def cg_sum(x):
        return x.reshape(-1, ncg, 4, ncg, 4).sum(dim=(2, 4))

    d_zero = cg_sum(c * c)
    d_now = cg_sum(e_now * e_now)
    r_now = cg_sum(rcost(l_abs))
    if psy_fx:
        r_now = r_now - cg_sum(credit(l_abs))
    any_nz = cg_sum(l_abs) > 0
    # lam_fx is [N,1,1], broadcasting over the [N,ncg,ncg] CG grid
    if consts is not None:
        save = r_now + ((lam_fx * cg_gain) >> 15)
    else:
        save = r_now - lam_fx
    zero_cg = any_nz & (32 * (d_zero - d_now) < save)
    z = zero_cg[:, :, None, :, None]
    out5 = out.reshape(-1, ncg, 4, ncg, 4)
    out5 = torch.where(z, torch.zeros_like(out5), out5)
    return out5.reshape(-1, n, n).to(torch.int32)


def rdoq_b(coeff, lvl, qp, n: int, bd: int, scaling: bool = False,
           is_intra: bool = False, consts=None, psy_fx: int = 0):
    """Batched integer RDOQ (bit-exact vs rdoq_adjust / oracle rdoq).
    consts: None, or an [8] int32 tensor or array."""
    if consts is not None and not isinstance(consts, torch.Tensor):
        consts = torch.from_numpy(np.asarray(consts, np.int32))
    return _rdoq_x64(coeff, lvl, qp, n, bd, scaling, is_intra, consts,
                     psy_fx)


@lru_cache(maxsize=16)
def _scans_dev(n: int, device: str) -> torch.Tensor:
    log2 = n.bit_length() - 1
    scans = [SCANS[(log2, si)] if (log2, si) in SCANS else SCANS[(log2, 0)]
             for si in (0, 1, 2)]
    return torch.from_numpy(np.stack(
        [np.asarray(s, np.int64).reshape(-1) for s in scans])).to(device)


def _first_true(mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first True along dim (0 when there is none) — the
    argmax-of-bool idiom with the first-index rule spelled out."""
    n = mask.shape[dim]
    shape = [1] * mask.dim()
    shape[dim] = n
    ar = torch.arange(n, device=mask.device).reshape(shape)
    first = torch.where(mask, ar, n).amin(dim=dim)
    return torch.where(first == n, torch.zeros_like(first), first)


def sbh_b(lvl: torch.Tensor, scan_sel: torch.Tensor, n: int) -> torch.Tensor:
    """Batched sign-bit-hiding pre-adjust (sbh_adjust / oracle
    sign_bit_hiding_adjust): per 16-coeff scan group with lastNZ-firstNZ>3,
    force parity(sum|l|) == sign(firstNZ) by nudging the first NZ level.

    lvl [N,n,n]; scan_sel [N] in {0,1,2} picks the scan order (diag/hor/
    vert — mode-dependent for small intra TUs).
    """
    scans = _scans_dev(n, str(lvl.device))                  # [3, n*n]
    N = lvl.shape[0]
    flat = lvl.reshape(N, n * n)
    scan = scans[scan_sel.long()]                           # [N, n*n]
    s = torch.gather(flat, 1, scan)                         # scanned order
    ncg = (n * n) // 16
    g = s.reshape(N, ncg, 16)
    nz = g != 0
    any_nz = nz.any(dim=2)
    first = _first_true(nz, 2)                              # first NZ idx
    last = 15 - _first_true(nz.flip(2), 2)
    asum = g.abs().sum(dim=2)
    firstval = torch.gather(g, 2, first[:, :, None])[:, :, 0]
    want = (firstval < 0).to(asum.dtype)
    need = any_nz & (last - first > 3) & ((asum & 1) != want)
    # adjustment: +/-1 toward even parity; |1| goes to 2 (never to 0)
    sg = torch.sign(firstval)
    adj = torch.where(firstval.abs() == 1, firstval + sg, firstval - sg)
    newval = torch.where(need, adj, firstval)
    ar16 = torch.arange(16, device=lvl.device)[None, None, :]
    g = torch.where((ar16 == first[:, :, None]) & need[:, :, None],
                    newval[:, :, None], g)
    s = g.reshape(N, n * n)
    # inverse scatter: flat[scan[i]] = s[i]
    out = torch.zeros_like(flat).scatter_(1, scan, s)
    return out.reshape(N, n, n)


def _tq_chain(resi: torch.Tensor, qp: torch.Tensor, scan_sel: torch.Tensor,
              n: int, dst: bool, is_intra: bool, bd: int, sdh: bool,
              do_rdoq: bool, lossless: bool, scaling: bool = False,
              consts=None, psy_fx: int = 0):
    if lossless:
        cbf = (resi != 0).any(dim=2).any(dim=1)
        return resi, resi, cbf
    cf = fwd_transform_b(resi, n, dst, bd)
    lvl = quantize_b(cf, qp, n, is_intra, bd, scaling)
    if do_rdoq:
        lvl = _rdoq_x64(cf, lvl, qp, n, bd, scaling, is_intra, consts,
                        psy_fx)
    if sdh:
        nzb = (lvl != 0).any(dim=2).any(dim=1)
        lvl = torch.where(nzb[:, None, None], sbh_b(lvl, scan_sel, n), lvl)
    cbf = (lvl != 0).any(dim=2).any(dim=1)
    deq = dequantize_b(lvl, qp, n, bd, scaling, is_intra)
    rr = inv_transform_b(deq, n, dst, bd)
    rres = torch.where(cbf[:, None, None], rr, torch.zeros_like(rr))
    return lvl, rres, cbf


def tq_chain(resi, qp, scan_sel, n: int, dst: bool, is_intra: bool,
             bd: int, sdh: bool, do_rdoq: bool, lossless: bool,
             scaling: bool = False, consts=None, psy_fx: int = 0):
    """The full coeffs_from_pred / tb_process transform chain for a batch
    of same-size TUs: residual -> (levels, recon-residual, cbf).

    resi [N,n,n] int32; qp [N] (already plane-adjusted Qp'); scan_sel [N]
    scan index for SBH. Returns (levels int32 [N,n,n], rres int32 [N,n,n],
    cbf bool [N]). With X265TPU_CHECKIFY=1 the chain's invariants are
    checked (utils/checks.py) and a violated one raises.
    """
    from x265_tpu_torch.utils import checks
    if checks.enabled():
        return checks.checked_tq_chain(resi, qp, scan_sel, n, dst,
                                       is_intra, bd, sdh, do_rdoq,
                                       lossless, scaling, consts, psy_fx)
    return _tq_chain(resi, qp, scan_sel, n, dst, is_intra, bd, sdh,
                     do_rdoq, lossless, scaling, consts, psy_fx)
