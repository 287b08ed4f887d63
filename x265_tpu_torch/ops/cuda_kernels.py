"""SATD, the block-SAD searches, the deblocking boundary strengths and the
RD passes' TB costs: the Hopper kernels' wrappers and their plain PyTorch
versions.

Counterpart of x265_tpu/ops/pallas_kernels.py (satd8x8_pallas /
satd_pallas, sad_sweep_pallas); the kernels are csrc/satd.cu and
csrc/sad_sweep.cu. SATD has two entries: satd (two int32 operands) and
satd_intra (one int16 operand against zero: the lookahead's intra cost).
The sweep has three: sad_sweep (the field, what the TPU kernel returns),
sad_sweep_argmin (fused with the mv cost and the argmin, over one plane
or a stack of P; serves engine.me._int_stage and the lookahead) and
sad_local_argmin (a window and an mv cost of its own for every block;
serves engine.me._local_search). deblock_bs (csrc/deblock_bs.cu) derives
both directions' boundary strengths of a picture in one launch for
models/loopfilter.py; the JAX package derives them on the host with
hevc/deblock.derive_bs, which stays the reference. rd_tb_cost
(csrc/rd_cost.cu) runs the RD passes' whole transform chain of a batch of
TBs in one launch and returns the four integers they keep of each; the
JAX package leaves that chain to XLA. On a CUDA tensor a
wrapper launches its kernel or raises; on a CPU tensor it runs the plain
version. The launch counts live with the other kernels' in
ops.cuda_mc.launches.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from x265_tpu_torch.hevc.deblock import NOPOC
from x265_tpu_torch.hevc.tables import (DEQUANT_SCALES, QUANT_SCALES,
                                        RDOQ_LAM32, default_scaling_matrix)
from x265_tpu_torch.models.intra_frame import first_argmin
from x265_tpu_torch.models.residual import _tmat, _tq_chain
from x265_tpu_torch.ops import cuda_build, cuda_mc
from x265_tpu_torch.utils import profiling

# 8x8 Hadamard matrix for SATD (row order of engine.me in the JAX package)
_H8 = np.array([[1, 1, 1, 1, 1, 1, 1, 1],
                [1, -1, 1, -1, 1, -1, 1, -1],
                [1, 1, -1, -1, 1, 1, -1, -1],
                [1, -1, -1, 1, 1, -1, -1, 1],
                [1, 1, 1, 1, -1, -1, -1, -1],
                [1, -1, 1, -1, -1, 1, -1, 1],
                [1, 1, -1, -1, -1, -1, 1, 1],
                [1, -1, -1, 1, -1, 1, 1, -1]], dtype=np.int32)


def satd_plain(a, b):
    """SATD over [N, S, S] blocks (S multiple of 8) -> [N] int32: the
    two-sided Hadamard as matrix products. They run in float32, which is
    exact here: every entry of H8 D H8^T is an integer below 64 * 2^12
    < 2^24 for any bit depth up to 12 (TF32 is off package-wide)."""
    N, S, _ = a.shape
    k = S // 8
    d = (a.to(torch.int32) - b.to(torch.int32)).reshape(N, k, 8, k, 8)
    d = d.permute(0, 1, 3, 2, 4).reshape(-1, 8, 8).to(torch.float32)
    h = torch.from_numpy(_H8).to(device=a.device, dtype=torch.float32)
    t = torch.matmul(torch.matmul(h, d), h.t())
    s = t.abs().sum(dim=(1, 2)).to(torch.int64) // 4
    return s.reshape(N, -1).sum(dim=1).to(torch.int32)


def satd(a, b):
    """SATD over [N, S, S] int32 blocks (S a multiple of 8) -> [N] int32
    (per-8x8 sa8d sums, as engine.me.satd8_batched defines it)."""
    for t, nm in ((a, "a"), (b, "b")):
        cuda_mc._check(t, nm, torch.int32, 3, a.device)
    if a.shape != b.shape or a.shape[1] != a.shape[2] or a.shape[1] % 8:
        raise ValueError(f"bad SATD block shapes {tuple(a.shape)} "
                         f"{tuple(b.shape)}")
    dev = a.device
    if dev.type != "cuda":
        return satd_plain(a, b)
    N, S, _ = a.shape
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("SATD operands must be 16-byte aligned")
    out = torch.empty((N,), dtype=torch.int32, device=dev)
    if N:
        lib = cuda_build.get_lib()
        with torch.cuda.device(dev):
            err = lib.x265_satd8(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                 N, S, cuda_mc._stream(dev))
        cuda_build.check_launch(err, "satd8x8")
        cuda_mc.launches["satd8x8"] += 1
    return out


def satd_intra_plain(a):
    """SATD of [N, 8, 8] blocks against zero -> [N] int32."""
    return satd_plain(a, torch.zeros_like(a))


def satd_intra(a):
    """SATD of [N, 8, 8] int16 blocks against zero -> [N] int32: the
    intra cost of DC-removed lowres blocks (engine.lookahead), with one
    operand and half-width samples, a quarter of satd's bytes. Equal to
    satd(a, zeros) for any int16 input."""
    cuda_mc._check(a, "a", torch.int16, 3)
    if tuple(a.shape[1:]) != (8, 8):
        raise ValueError(f"satd_intra takes [N, 8, 8] blocks, got "
                         f"{tuple(a.shape)}")
    dev = a.device
    if dev.type != "cuda":
        return satd_intra_plain(a)
    if a.data_ptr() % 16:
        raise ValueError("satd_intra's operand must be 16-byte aligned")
    N = a.shape[0]
    out = torch.empty((N,), dtype=torch.int32, device=dev)
    if N:
        lib = cuda_build.get_lib()
        with torch.cuda.device(dev):
            err = lib.x265_satd8_intra(a.data_ptr(), out.data_ptr(), N,
                                       cuda_mc._stream(dev))
        cuda_build.check_launch(err, "satd8x8_intra")
        cuda_mc.launches["satd8x8_intra"] += 1
    return out


def satd8x8(a, b):
    """sa8d of [N, 8, 8] int32 blocks -> [N] int32."""
    if a.shape[1:] != (8, 8):
        raise ValueError("satd8x8 takes [N, 8, 8] blocks")
    return satd(a, b)


# ---------------------------------------------------------- dense SAD sweep

def _sad_rows(cur, ref_pad, S: int, R: int):
    """Yields, for dy = 0..2R, the SAD of every S x S block at the 2R+1
    displacements of that row: [nby, 2R+1, nbx] int32 (int16 differences,
    int32 block sums)."""
    H, W = cur.shape
    nby, nbx = H // S, W // S
    n = 2 * R + 1
    for dy in range(n):
        win = ref_pad[dy:dy + H, :].unfold(1, W, 1)         # [H, n, W]
        ad = (cur[:, None, :] - win).abs()
        yield ad.reshape(nby, S, n, nbx, S).sum(dim=(1, 4),
                                                dtype=torch.int32)


def sad_sweep_plain(cur, ref_pad, S: int, R: int):
    """The SAD field [(2R+1)^2, nby, nbx] float32, one row of
    displacements per step."""
    n = 2 * R + 1
    rows = [sad.permute(1, 0, 2) for sad in _sad_rows(cur, ref_pad, S, R)]
    return torch.stack(rows).reshape(n * n, *rows[0].shape[1:]).to(
        torch.float32)


def sad_sweep_argmin_plain(cur, ref_pad, mvcost, S: int, R: int):
    """First minimum of float(sad) + mvcost[d] over d = dy*n + dx. One
    step per dy covers every dx of that row at once; inside a row the
    first minimum wins, across rows a strict < keeps the earlier one: the
    same winner as a displacement-by-displacement scan in d order. A stack
    [P, H, W] is costed one plane at a time."""
    if cur.dim() == 3:
        P, H, W = cur.shape
        idx = torch.empty((P, H // S, W // S), dtype=torch.int32,
                          device=cur.device)
        cost = torch.empty((P, H // S, W // S), dtype=torch.float32,
                           device=cur.device)
        for p in range(P):
            idx[p], cost[p] = sad_sweep_argmin_plain(cur[p], ref_pad[p],
                                                     mvcost, S, R)
        return idx, cost
    H, W = cur.shape
    nby, nbx = H // S, W // S
    n = 2 * R + 1
    dev = cur.device
    mvc = mvcost.reshape(n, n)
    best_cost = torch.full((nby, nbx), float("inf"), dtype=torch.float32,
                           device=dev)
    best_idx = torch.zeros((nby, nbx), dtype=torch.int64, device=dev)
    for dy, sad in enumerate(_sad_rows(cur, ref_pad, S, R)):
        cost = sad.to(torch.float32) + mvc[dy][None, :, None]  # [nby,n,nbx]
        k = first_argmin(cost, 1)
        c = torch.gather(cost, 1, k[:, None, :])[:, 0, :]
        upd = c < best_cost
        best_cost = torch.where(upd, c, best_cost)
        best_idx = torch.where(upd, dy * n + k, best_idx)
    return best_idx.to(torch.int32), best_cost


def _check_sweep(cur, ref_pad, S, R, batch=False):
    """(H, W) of cur [H, W] (or, with batch, [P, H, W]) and its ref_pad."""
    nd = 3 if batch and cur.dim() == 3 else 2
    cuda_mc._check(cur, "cur", torch.int16, nd)
    cuda_mc._check(ref_pad, "ref_pad", torch.int16, nd, cur.device)
    H, W = cur.shape[-2:]
    if S not in (4, 8, 16, 32) or R < 0 or H < S or W < S or H % S or W % S:
        raise ValueError(f"bad SAD sweep geometry: cur {H}x{W}, S={S}, R={R}")
    want = (*cur.shape[:-2], H + 2 * R, W + 2 * R)
    if tuple(ref_pad.shape) != want:
        raise ValueError(f"ref_pad is {tuple(ref_pad.shape)}, expected "
                         f"{want}")
    if nd == 3 and cur.shape[0] > 65535:
        raise ValueError(f"{cur.shape[0]} planes: at most 65535 a launch")
    if ((S + 2 * R) ** 2 + S * S) * 2 > 48 * 1024:
        raise ValueError(f"search window of S={S}, R={R} does not fit a "
                         "thread block's shared memory")
    return H, W


def sad_sweep(cur, ref_pad, S: int, R: int):
    """SAD of every S x S block of cur [H,W] int16 against ref_pad
    [H+2R,W+2R] int16 at every displacement d = dy*(2R+1) + dx ->
    [(2R+1)^2, H/S, W/S] float32 (what sad_sweep_pallas returns)."""
    H, W = _check_sweep(cur, ref_pad, S, R)
    dev = cur.device
    if dev.type != "cuda":
        return sad_sweep_plain(cur, ref_pad, S, R)
    n = 2 * R + 1
    out = torch.empty((n * n, H // S, W // S), dtype=torch.float32,
                      device=dev)
    lib = cuda_build.get_lib()
    with torch.cuda.device(dev):
        err = lib.x265_sad_sweep(cur.data_ptr(), ref_pad.data_ptr(),
                                 out.data_ptr(), H, W, S, R,
                                 cuda_mc._stream(dev))
    cuda_build.check_launch(err, "sad_sweep")
    cuda_mc.launches["sad_sweep"] += 1
    return out


def sad_sweep_argmin(cur, ref_pad, mvcost, S: int, R: int):
    """The sweep fused with its argmin: for every block the FIRST d that
    minimises float32(sad) + mvcost[d] (mvcost [(2R+1)^2] float32, lambda
    already applied) -> (best_idx [H/S, W/S] int32, best_cost float32).
    cur [P, H, W] with ref_pad [P, H+2R, W+2R] costs P planes in one
    launch against one mvcost -> [P, H/S, W/S] each. Serves
    engine.me._int_stage and engine.lookahead."""
    H, W = _check_sweep(cur, ref_pad, S, R, batch=True)
    dev = cur.device
    cuda_mc._check(mvcost, "mvcost", torch.float32, 1, dev)
    n = 2 * R + 1
    if mvcost.shape[0] != n * n:
        raise ValueError(f"mvcost has {mvcost.shape[0]} entries, expected "
                         f"{n * n}")
    if dev.type != "cuda":
        return sad_sweep_argmin_plain(cur, ref_pad, mvcost, S, R)
    lead = tuple(cur.shape[:-2])
    P = lead[0] if lead else 1
    idx = torch.empty((*lead, H // S, W // S), dtype=torch.int32, device=dev)
    cost = torch.empty((*lead, H // S, W // S), dtype=torch.float32,
                       device=dev)
    if P:
        lib = cuda_build.get_lib()
        with torch.cuda.device(dev):
            err = lib.x265_sad_sweep_argmin(
                cur.data_ptr(), ref_pad.data_ptr(), mvcost.data_ptr(),
                idx.data_ptr(), cost.data_ptr(), H, W, S, R, P,
                cuda_mc._stream(dev))
        cuda_build.check_launch(err, "sad_sweep_argmin")
        cuda_mc.launches["sad_sweep_argmin"] += 1
    return idx, cost


# ------------------------------------------------- per-block window search

def mv_bits_t(a: torch.Tensor) -> torch.Tensor:
    """~exp-Golomb bit count 2*floor(log2(2a+1)) + 1 of a non-negative
    integer tensor, by integer bit length: floor(log2(x)) counted as the
    number of thresholds 2^k <= x (exact; equal to the float form, proven
    by test over the whole mv range). Returns float32."""
    x = 2 * a.to(torch.int32) + 1
    lg = torch.zeros_like(x)
    for k in range(1, 24):
        lg += (x >= (1 << k)).to(torch.int32)
    return (2 * lg + 1).to(torch.float32)


def sad_local_argmin_plain(cur_blocks, ref_pad, y0s, x0s, centers, lam,
                           S: int, W_r: int):
    """The window search one row of displacements a step: the patches
    gathered whole, then for every dy all dx at once. Inside a row the
    first minimum wins, across rows a strict < keeps the earlier one: the
    winner of a displacement-by-displacement scan in d order."""
    N = cur_blocks.shape[0]
    dev = cur_blocks.device
    patches = cuda_mc.tile_gather_plain(ref_pad, y0s, x0s, S + 2 * W_r)
    n = 2 * W_r + 1
    dxs = torch.arange(n, device=dev, dtype=torch.int32) - W_r
    bits_x = mv_bits_t((4 * (centers[:, 0:1] + dxs[None, :])).abs())  # [N,n]
    best_cost = torch.full((N,), float("inf"), dtype=torch.float32,
                           device=dev)
    best_d = torch.zeros((N,), dtype=torch.int64, device=dev)
    for dy in range(n):
        rows = patches[:, dy:dy + S, :].unfold(2, S, 1)     # [N,S,n,S]
        sad = (cur_blocks[:, :, None, :] - rows).abs().sum(
            dim=(1, 3), dtype=torch.int32)                  # [N,n]
        bits_y = mv_bits_t((4 * (centers[:, 1] + (dy - W_r))).abs())
        bits = bits_x + bits_y[:, None]
        cost = sad.to(torch.float32) + lam * bits
        k = first_argmin(cost, 1)
        c = torch.gather(cost, 1, k[:, None])[:, 0]
        upd = c < best_cost
        best_cost = torch.where(upd, c, best_cost)
        best_d = torch.where(upd, dy * n + k, best_d)
    return best_d.to(torch.int32), best_cost


def sad_local_argmin(cur_blocks, ref_pad, y0s, x0s, centers, lam,
                     S: int, W_r: int):
    """Per-block window search: for block i the (S + 2*W_r)^2 patch of
    ref_pad at (y0s[i], x0s[i]), clipped into the plane as tile_gather
    clips, is scanned at the (2*W_r + 1)^2 displacements d = dy*n + dx for
    the FIRST minimum of float32(sad) + lam * (bits(4*(cx+dx-W_r)) +
    bits(4*(cy+dy-W_r))), (cx, cy) = centers[i] -> (best_d [N] int32,
    best_cost [N] float32). Serves engine.me._local_search.

    cur_blocks [N,S,S] int32 (samples that fit int16), S in (8, 16, 32,
    64); ref_pad [Hp,Wp] int16 whose rows are contiguous (any row pitch: a
    crop of a larger plane is taken as it is); y0s/x0s [N] int32; centers
    [N,2] int32; lam a 0-dim float32 tensor; S + 2*W_r at most 78."""
    cuda_mc._check(cur_blocks, "cur_blocks", torch.int32, 3)
    dev = cur_blocks.device
    cuda_mc._check_lanes(dev, y0s=y0s, x0s=x0s)
    cuda_mc._check(centers, "centers", torch.int32, 2, dev)
    cuda_mc._check(lam, "lam", torch.float32, 0, dev)
    if not isinstance(ref_pad, torch.Tensor) or ref_pad.dtype != torch.int16:
        raise TypeError("ref_pad: expected an int16 tensor")
    if ref_pad.dim() != 2 or ref_pad.device != dev:
        raise ValueError(f"ref_pad: expected 2 dims on {dev}")
    Hp, Wp = ref_pad.shape
    if ref_pad.stride(1) != 1 or ref_pad.stride(0) < Wp:
        raise ValueError("ref_pad: rows must be contiguous")
    side = S + 2 * W_r
    if (S not in (8, 16, 32, 64) or W_r < 0 or side > Hp or side > Wp
            or side > cuda_mc._MAX_STAGED_TILE):
        raise ValueError(f"bad window search geometry: S={S}, W_r={W_r}, "
                         f"ref_pad {Hp}x{Wp}")
    N = cur_blocks.shape[0]
    if tuple(cur_blocks.shape[1:]) != (S, S):
        raise ValueError(f"cur_blocks is {tuple(cur_blocks.shape)}, expected "
                         f"[N, {S}, {S}]")
    if y0s.shape[0] != N or tuple(centers.shape) != (N, 2):
        raise ValueError(f"y0s/x0s/centers do not match {N} blocks")
    if dev.type != "cuda":
        return sad_local_argmin_plain(cur_blocks, ref_pad, y0s, x0s, centers,
                                      lam, S, W_r)
    if cur_blocks.data_ptr() % 16:
        raise ValueError("cur_blocks must be 16-byte aligned")
    best_d = torch.empty((N,), dtype=torch.int32, device=dev)
    best_cost = torch.empty((N,), dtype=torch.float32, device=dev)
    if N:
        lib = cuda_build.get_lib()
        with torch.cuda.device(dev):
            err = lib.x265_sad_local_argmin(
                cur_blocks.data_ptr(), ref_pad.data_ptr(), y0s.data_ptr(),
                x0s.data_ptr(), centers.data_ptr(), lam.data_ptr(),
                best_d.data_ptr(), best_cost.data_ptr(), N, S, W_r, Hp, Wp,
                ref_pad.stride(0), cuda_mc._stream(dev))
        cuda_build.check_launch(err, "sad_local_argmin")
        cuda_mc.launches["sad_local_argmin"] += 1
    return best_d, best_cost


# ------------------------------------------------ deblocking boundary strength

# bits of deblock_bs's flag map
BS_EDGE_V, BS_EDGE_H, BS_INTRA, BS_CBF = 1, 2, 4, 8


def deblock_bs_flags(edge_v, edge_h, is_intra4, cbf4, out=None):
    """The uint8 flag map deblock_bs reads, from the four [h4, w4] maps
    (any integer or bool arrays; nonzero is set), written into `out` when
    given."""
    def bit(a, k):
        return np.left_shift(np.asarray(a, bool).view(np.uint8), k)

    if out is None:
        out = np.empty(np.shape(edge_v), np.uint8)
    np.bitwise_or(np.asarray(edge_v, bool).view(np.uint8), bit(edge_h, 1),
                  out=out)
    out |= bit(is_intra4, 2)
    out |= bit(cbf4, 3)
    return out


def _bs_dir(f, mv, poc, dim: int, edge: int):
    """bS of the edge between every block and its neighbour before it
    along `dim`, as hevc.deblock.derive_bs computes it: its roll wraps
    around only into the first column (row), which is zeroed."""
    pf, pmv, ppoc = (torch.roll(t, 1, dim) for t in (f, mv, poc))
    p_used, q_used = ppoc != NOPOC, poc != NOPOC
    p_n, q_n = p_used.sum(-1), q_used.sum(-1)

    def uni(u, pc, m):
        return (torch.where(u[..., 0], pc[..., 0], pc[..., 1]),
                torch.where(u[..., 0:1], m[..., 0, :], m[..., 1, :]))

    def close(a, b):
        return (a - b).abs().amax(-1) < 4

    p1poc, p1mv = uni(p_used, ppoc, pmv)
    q1poc, q1mv = uni(q_used, poc, mv)
    uni_bs1 = (p1poc != q1poc) | ~close(p1mv, q1mv)
    straight = ((ppoc[..., 0] == poc[..., 0]) & (ppoc[..., 1] == poc[..., 1])
                & close(pmv[..., 0, :], mv[..., 0, :])
                & close(pmv[..., 1, :], mv[..., 1, :]))
    crossed = ((ppoc[..., 0] == poc[..., 1]) & (ppoc[..., 1] == poc[..., 0])
               & close(pmv[..., 0, :], mv[..., 1, :])
               & close(pmv[..., 1, :], mv[..., 0, :]))
    mv_bs1 = torch.where((p_n == 1) & (q_n == 1), uni_bs1,
                         torch.where((p_n == 2) & (q_n == 2),
                                     ~(straight | crossed), True))
    both = pf | f
    bs = torch.where((both & BS_INTRA) != 0, 2,
                     (((both & BS_CBF) != 0) | mv_bs1).to(torch.int32))
    bs = torch.where((f & edge) != 0, bs, 0).to(torch.int32)
    bs.select(dim, 0).zero_()      # the picture's edge is not filtered
    return bs


def deblock_bs_plain(flags, mv4, refpoc4):
    """(bs_v, bs_h) as whole-map tensor ops (int32 arithmetic)."""
    f = flags.to(torch.int32)
    mv = mv4.to(torch.int32)
    poc = refpoc4.to(torch.int32)
    return (_bs_dir(f, mv, poc, 1, BS_EDGE_V),
            _bs_dir(f, mv, poc, 0, BS_EDGE_H))


def deblock_bs(flags, mv4, refpoc4):
    """Boundary strengths of every 4x4 block's left (bs_v) and top (bs_h)
    edge, int32 [h4, w4] each, as hevc.deblock.derive_bs gives them for
    both directions. flags uint8 [h4, w4] (deblock_bs_flags); mv4 int16
    [h4, w4, 2, 2] quarter-pel; refpoc4 int32 [h4, w4, 2], NOPOC where a
    list is unused. One launch for both maps."""
    cuda_mc._check(flags, "flags", torch.uint8, 2)
    dev = flags.device
    cuda_mc._check(mv4, "mv4", torch.int16, 4, dev)
    cuda_mc._check(refpoc4, "refpoc4", torch.int32, 3, dev)
    h4, w4 = flags.shape
    if (tuple(mv4.shape) != (h4, w4, 2, 2)
            or tuple(refpoc4.shape) != (h4, w4, 2)):
        raise ValueError(f"mv4 {tuple(mv4.shape)} / refpoc4 "
                         f"{tuple(refpoc4.shape)} do not match flags "
                         f"[{h4}, {w4}]")
    if dev.type != "cuda":
        return deblock_bs_plain(flags, mv4, refpoc4)
    if mv4.data_ptr() % 8 or refpoc4.data_ptr() % 8:
        raise ValueError("mv4 and refpoc4 must be 8-byte aligned")
    bs_v = torch.empty((h4, w4), dtype=torch.int32, device=dev)
    bs_h = torch.empty((h4, w4), dtype=torch.int32, device=dev)
    if h4 * w4:
        lib = cuda_build.get_lib()
        with torch.cuda.device(dev):
            err = lib.x265_deblock_bs(flags.data_ptr(), mv4.data_ptr(),
                                      refpoc4.data_ptr(), bs_v.data_ptr(),
                                      bs_h.data_ptr(), h4, w4,
                                      cuda_mc._stream(dev))
        cuda_build.check_launch(err, "deblock_bs")
        cuda_mc.launches["deblock_bs"] += 1
    return bs_v, bs_h


# ------------------------------------------------------- the RD passes' TB costs

def rd_tb_cost_plain(src, pred, qp, rk, is_intra, bd, sdh, do_rdoq, scaling,
                     want_psy):
    """rd_tb_cost's four integers composed from the chain's own functions:
    models/residual._tq_chain (diagonal scan, no transform skip, not
    lossless), the integer part of models/rdo._tb_rate_bits_j and
    models/rdo._psy_energy8."""
    from x265_tpu_torch.models.rdo import _psy_energy8, _tb_rate_fx
    N, S, _ = src.shape
    resi = src - pred
    lvl, rres, cbf = _tq_chain(
        resi, qp, torch.zeros((N,), dtype=torch.int32, device=src.device),
        S, False, is_intra, bd, sdh, do_rdoq, False, scaling)
    e = (resi - rres).to(torch.int64)
    sse = (e * e).sum(dim=(1, 2))
    if want_psy:
        rec = (pred + rres).clamp(0, (1 << bd) - 1)
        psy = (_psy_energy8(src) - _psy_energy8(rec)).abs().sum(
            dim=1, dtype=torch.int64)
    else:
        psy = torch.zeros_like(sse)
    return sse, _tb_rate_fx(lvl, rk), psy, cbf


@lru_cache(maxsize=32)
def _rd_tables(S: int, is_intra: bool, scaling: bool, device: str):
    """rd_tb_cost's constants on the device: int32 (the DCT matrix, the
    scaling matrix or 16 everywhere, the quant and dequant scales) and the
    static RDOQ lambda table as int64."""
    m = (default_scaling_matrix(S, is_intra) if scaling
         else np.full((S, S), 16))
    tab = np.concatenate([_tmat(S, False).reshape(-1), m.reshape(-1),
                          QUANT_SCALES, DEQUANT_SCALES]).astype(np.int32)
    return (torch.from_numpy(tab).to(device),
            torch.from_numpy(np.asarray(RDOQ_LAM32, np.int64)).to(device))


def rd_tb_cost(src, pred, qp, rk, is_intra, bd, sdh, do_rdoq, scaling,
               want_psy):
    """The RD passes' cost of N same-size TBs coded from int32 predictions:
    the transform chain of models/residual._tq_chain (quant, RDOQ's static
    branch when do_rdoq, SBH when sdh, dequant, inverse) reduced to
    (sse int64 [N], rate int64 [N] in Q15 (before the cbf gate), psy
    int64 [N] (zero unless want_psy), cbf bool [N]). src, pred int32
    [N, S, S] with S in 8, 16, 32; qp int32 [N], the plane's Qp'; rk int32
    [8], the plane's rate constants. One launch; the TBs handed to RDOQ
    count in `rdoq.tbs` as the chain counts them."""
    cuda_mc._check(src, "src", torch.int32, 3)
    dev = src.device
    cuda_mc._check(pred, "pred", torch.int32, 3, dev)
    cuda_mc._check(qp, "qp", torch.int32, 1, dev)
    cuda_mc._check(rk, "rk", torch.int32, 1, dev)
    N, S, S2 = src.shape
    if (S != S2 or S not in (8, 16, 32) or pred.shape != src.shape
            or tuple(qp.shape) != (N,) or tuple(rk.shape) != (8,)):
        raise ValueError(f"src {tuple(src.shape)} / pred "
                         f"{tuple(pred.shape)} / qp {tuple(qp.shape)} / rk "
                         f"{tuple(rk.shape)}: expected [N, S, S] twice with "
                         f"S in 8, 16, 32, [N] and [8]")
    if not 8 <= bd <= 10:
        raise ValueError(f"bit depth {bd}: 8 to 10")
    if dev.type != "cuda":
        return rd_tb_cost_plain(src, pred, qp, rk, is_intra, bd, sdh,
                                do_rdoq, scaling, want_psy)
    out = torch.empty((N, 4), dtype=torch.int64, device=dev)
    if N:
        tab, lam = _rd_tables(S, bool(is_intra), bool(scaling), str(dev))
        lib = cuda_build.get_lib()
        with torch.cuda.device(dev):
            err = lib.x265_rd_tb_cost(
                src.data_ptr(), pred.data_ptr(), qp.data_ptr(),
                rk.data_ptr(), tab.data_ptr(), lam.data_ptr(),
                out.data_ptr(), N, S, int(bool(is_intra)), bd,
                int(bool(sdh)), int(bool(do_rdoq)), int(bool(scaling)),
                int(bool(want_psy)), cuda_mc._stream(dev))
        cuda_build.check_launch(err, "rd_tb_cost")
        cuda_mc.launches["rd_tb_cost"] += 1
    if do_rdoq:
        profiling.count("rdoq.tbs", N)
    return out[:, 0], out[:, 1], out[:, 2], out[:, 3] != 0
