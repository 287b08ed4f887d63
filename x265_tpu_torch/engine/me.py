"""Batched motion estimation — the re-imagining of x265's serial
MotionEstimate::motionEstimate loop (reference motion.cpp:739, subpel
refine motion.cpp:624 area) as dense frame-level computation:

- integer search: a dense displacement sweep of shifted-frame SAD
  reductions (2-level hierarchical beyond +-24), with a lambda*mvbits
  penalty per displacement;
- subpel: 16 quarter-pel phase planes built once per frame by separable
  8-tap interpolation, then refinement rounds evaluate 9 candidates per
  block with batched SATD + mv cost.

The window gathers (tile_gather, tile_gather_planes), the SATD, the
gather fused with the SATD (tile_gather_planes_satd: the subpel rounds
score their candidates without building the candidates' blocks), the
dense SAD sweep with its argmin (sad_sweep_argmin) and the per-block
window search around the HME centres (sad_local_argmin) are hand-written
CUDA kernels (ops/cuda_mc.py, ops/cuda_kernels.py); the rest is plain
PyTorch. Ties
keep the FIRST minimal candidate everywhere,
as the scans and argmins of the JAX package do.

MV cost model: quarter-pel exp-Golomb-ish bit estimate against the
neighbourhood-median predictor.
"""
from __future__ import annotations

import numpy as np
import torch

from x265_tpu_torch.models.intra_frame import first_argmin
from x265_tpu_torch.ops.cuda_kernels import mv_bits_t as _mv_bits_t
from x265_tpu_torch.ops.cuda_kernels import (sad_local_argmin,
                                             sad_sweep_argmin)
from x265_tpu_torch.ops.cuda_kernels import satd as _satd_kernel
from x265_tpu_torch.ops.cuda_mc import (tile_gather_planes,
                                        tile_gather_planes_satd)
from x265_tpu_torch.ops.ref.interp import LUMA_FILTERS
from x265_tpu_torch.parallel import mesh as _mesh
from x265_tpu_torch.utils.device import resolve_device
from x265_tpu_torch.utils.profiling import scope


def _mv_bits(v: np.ndarray) -> np.ndarray:
    """~exp-Golomb bit count of a quarter-pel mv component."""
    a = np.abs(v).astype(np.int64)
    return (2 * np.floor(np.log2(2 * a + 1)) + 1).astype(np.float32)


def satd8_batched(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SATD over [N, S, S] blocks (S multiple of 8) -> [N] int32 (sa8d-
    style: sum |H8 D H8^T| / 4 per 8x8 sub-block; x265 pixel.cpp sa8d).
    Served by the SATD kernel on a CUDA device."""
    return _satd_kernel(a.to(torch.int32).contiguous(),
                        b.to(torch.int32).contiguous())


def _downscale2(y: torch.Tensor) -> torch.Tensor:
    """2x2 mean downscale (the frameInitLowres analog used by HME)."""
    H, W = y.shape
    y = y.to(torch.int32)
    s = y.reshape(H // 2, 2, W // 2, 2).sum(dim=(1, 3), dtype=torch.int32)
    return (s + 2) >> 2


def _local_search(cur_blocks, ref_pad, centers, bxy, lam, S, W_r, pad):
    """Per-block integer window search around given centers.

    cur_blocks [N,S,S]; ref_pad [H+2*pad, W+2*pad] edge-padded; centers
    [N,2] integer MVs with |center| <= pad - W_r; bxy [N,2] block (x,y)
    indices. Evaluates all (2W_r+1)^2 displacements around each center
    (the x265 refineMV/star-refine analog, motion.cpp:624) in dy-major,
    dx-minor order, keeping the first minimum -> (mv [N,2], cost [N]).
    The search patches, the SADs, the mv cost and the argmin are one
    kernel on a CUDA device (ops.cuda_kernels.sad_local_argmin); here only
    the origins and the index-to-mv arithmetic are left.
    """
    def i32(t):
        return t.to(torch.int32).contiguous()

    # top-left of every search patch in padded coords
    y0s = bxy[:, 1] * S + centers[:, 1] + pad - W_r
    x0s = bxy[:, 0] * S + centers[:, 0] + pad - W_r
    ref_pad = ref_pad.to(torch.int16)
    if ref_pad.stride(1) != 1:
        ref_pad = ref_pad.contiguous()
    n = 2 * W_r + 1
    best_d, best_cost = sad_local_argmin(
        i32(cur_blocks), ref_pad, i32(y0s), i32(x0s), i32(centers),
        torch.as_tensor(lam, dtype=torch.float32, device=cur_blocks.device),
        S, W_r)
    off = torch.stack([best_d % n - W_r,
                       torch.div(best_d, n, rounding_mode="floor") - W_r],
                      dim=-1)
    return centers + off, best_cost


def _phase_planes(ref_pad: torch.Tensor, maxv: int = 255) -> torch.Tensor:
    """[4,4,H+2m,W+2m] pixel-domain quarter-pel planes (int16) from a
    reference edge-padded by (m+3) left/top and (m+4) right/bottom, so
    that plane index i maps to integer position i-m (the 8-tap base
    sample is tap 3). Integer throughout: shifted-slice sums."""
    f = LUMA_FILTERS                       # [4, 8] numpy ints
    ref_pad = ref_pad.to(torch.int32)
    Hp, Wp = ref_pad.shape
    W_out = Wp - 7
    H_out = Hp - 7
    hor = []
    for p in range(4):
        acc = torch.zeros((Hp, W_out), dtype=torch.int32,
                          device=ref_pad.device)
        for t in range(8):
            c = int(f[p][t])
            if c:
                acc += c * ref_pad[:, t:t + W_out]
        hor.append(acc)
    hor = torch.stack(hor)                                 # [4, Hp, W_out]
    out = []
    for q in range(4):
        acc = torch.zeros((4, H_out, W_out), dtype=torch.int32,
                          device=ref_pad.device)
        for t in range(8):
            c = int(f[q][t])
            if c:
                acc += c * hor[:, t:t + H_out, :]
        out.append(acc)
    out = torch.stack(out)                                 # [4(v),4(h),H,W]
    out = (out + 2048) >> 12                               # /64/64 rounded
    return out.clamp_(0, maxv).to(torch.int16)


def _phase_lanes(planes, fy, fx, iy, ix):
    """[4,4,Hm,Wm] phase planes and per-lane (phase, position) as the
    gather kernels take them: stacked planes [16,Hm,Wm] and int32 plane
    index and origins. Each phase is clipped here, positions by the
    kernels (dynamic_slice clamp semantics)."""
    P1, P2, Hm, Wm = planes.shape
    ridx = (fy.clamp(0, P1 - 1) * P2 + fx.clamp(0, P2 - 1)).to(torch.int32)
    return (planes.reshape(P1 * P2, Hm, Wm), ridx.contiguous(),
            iy.to(torch.int32).contiguous(), ix.to(torch.int32).contiguous())


def _gather_phase_blocks(planes, fy, fx, iy, ix, S):
    """[N, S, S] int32 blocks from [4,4,Hm,Wm] int16 phase planes at
    per-lane (phase, position)."""
    return tile_gather_planes(*_phase_lanes(planes, fy, fx, iy, ix), S)


def _phase_satd(cur_blocks, planes, fy, fx, iy, ix, S):
    """SATD [K*N] int32 of cur_blocks [N,S,S] against the blocks
    _gather_phase_blocks would return for the K*N lanes (lane k*N + i
    against block i); the blocks themselves are never built (one fused
    kernel on a CUDA device)."""
    return tile_gather_planes_satd(
        *_phase_lanes(planes, fy, fx, iy, ix),
        cur_blocks.to(torch.int32).contiguous(), S)


def _refine(cur_blocks, planes, mv_q, offsets, lam, mvp_q, S, margin):
    """One subpel refinement round.

    cur_blocks [N,S,S]; planes [4,4,Hp,Wp] (padded by `margin` int pels);
    mv_q [N,4] current best quarter-pel MVs + packed block (x, y);
    offsets [K,2] quarter-pel deltas (0,0 included to keep the
    incumbent); mvp_q [N,2] the MV predictor the bit cost is measured
    against. Returns best mv [N,2] and its cost.
    """
    N = cur_blocks.shape[0]
    nbx_arr = mv_q[:, 2]
    nby_arr = mv_q[:, 3]
    base = mv_q[:, :2]
    K = offsets.shape[0]

    # all K offsets as ONE flattened lane batch, gathered and scored by
    # one kernel launch
    cands = base[None, :, :] + offsets[:, None, :]          # [K,N,2]
    fx = cands[..., 0] & 3
    fy = cands[..., 1] & 3
    ix = (cands[..., 0] >> 2) + (nbx_arr * S + margin)[None, :]
    iy = (cands[..., 1] >> 2) + (nby_arr * S + margin)[None, :]
    satd = _phase_satd(cur_blocks, planes, fy.reshape(-1), fx.reshape(-1),
                       iy.reshape(-1), ix.reshape(-1), S)
    satd = satd.to(torch.float32).reshape(K, N)
    bits = _mv_bits_t((cands - mvp_q[None]).abs()).sum(dim=2)
    costs = satd + lam * bits                      # [K,N]
    k = first_argmin(costs, 0)                     # [N]
    best = torch.gather(cands, 0, k[None, :, None].expand(1, N, 2))[0]
    cost = costs.amin(dim=0)
    return best, cost


_HALF_OFFS = np.array([(0, 0), (-2, 0), (2, 0), (0, -2), (0, 2),
                       (-2, -2), (-2, 2), (2, -2), (2, 2)], dtype=np.int32)
_QUARTER_OFFS = np.array([(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1),
                          (-1, -1), (-1, 1), (1, -1), (1, 1)], dtype=np.int32)


def subpel_rounds(subme: int):
    """Refinement schedule per --subme tier (x265 subme dial,
    motion.cpp subpelRefine iterations — re-imagined as batched
    8-neighbor rounds):
        <=1: half only          2-3: half + quarter (default)
        4:   half + 2x quarter  >=5: 2x half + 2x quarter
    A second round of the same step lets the minimum drift beyond the
    +-1 neighborhood the single round can reach."""
    if subme <= 1:
        return [_HALF_OFFS]
    if subme <= 3:
        return [_HALF_OFFS, _QUARTER_OFFS]
    if subme == 4:
        return [_HALF_OFFS, _QUARTER_OFFS, _QUARTER_OFFS]
    return [_HALF_OFFS, _HALF_OFFS, _QUARTER_OFFS, _QUARTER_OFFS]


def _eval_fixed(cur_blocks, planes, mv, bxy, S, margin):
    """SATD of every block at its given quarter-pel MV (one fused
    gather + SATD)."""
    fx = mv[:, 0] & 3
    fy = mv[:, 1] & 3
    ix = (mv[:, 0] >> 2) + bxy[:, 0] * S + margin
    iy = (mv[:, 1] >> 2) + bxy[:, 1] * S + margin
    return _phase_satd(cur_blocks, planes, fy, fx, iy, ix, S)


def _bi_satd(cur_blocks, planes0, planes1, mv0, mv1, bxy, S, margin):
    """SATD of the averaged bi-prediction per block (x265 checkBidir2Nx2N
    analog, analysis.cpp:3145): pixel-domain average of the two
    phase-plane predictions. Two launches of the gather's blocks entry,
    the average, then the SATD kernel."""
    def gather(planes, mv):
        fx = mv[:, 0] & 3
        fy = mv[:, 1] & 3
        ix = (mv[:, 0] >> 2) + bxy[:, 0] * S + margin
        iy = (mv[:, 1] >> 2) + bxy[:, 1] * S + margin
        return _gather_phase_blocks(planes, fy, fx, iy, ix, S)

    avg = (gather(planes0, mv0) + gather(planes1, mv1) + 1) >> 1
    return satd8_batched(cur_blocks, avg)


# ---------------------------------------------------------------------------
# The standalone motion API (one reference, host numpy in and out): the
# JAX package's motion_decide and the bundle functions over its aux. The
# encoder runs motion_fused below; these serve the --subme dial's tests and
# any caller that searches one reference.
# ---------------------------------------------------------------------------

def _int_search(cur, ref_pad, mvcost, S, R):
    """Integer full search. cur [H,W], ref_pad [H+2R, W+2R], mvcost
    [(2R+1)^2] float32 -> (best_idx [nby,nbx] int32, best_cost float32,
    best_sad int32): the first d minimising float32(sad) + mvcost[d], d in
    dy-major order. The sweep, the mv cost and the argmin are kernel 5's
    fused entry (ops.cuda_kernels.sad_sweep_argmin); best_sad, which that
    entry does not return, is the SAD at the winning d, one block each."""
    H, W = cur.shape
    nby, nbx = H // S, W // S
    n = 2 * R + 1
    cur = cur.to(torch.int16).contiguous()
    ref_pad = ref_pad.to(torch.int16).contiguous()
    idx, cost = sad_sweep_argmin(cur, ref_pad,
                                 mvcost.to(torch.float32).contiguous(), S, R)
    dev = cur.device
    ar = torch.arange(S, device=dev)
    oy = (torch.arange(nby, device=dev)[:, None] * S
          + torch.div(idx, n, rounding_mode="floor"))      # [nby, nbx]
    ox = torch.arange(nbx, device=dev)[None, :] * S + idx % n
    rows = (oy[..., None] + ar)[..., :, None]               # [nby,nbx,S,1]
    cols = (ox[..., None] + ar)[..., None, :]               # [nby,nbx,1,S]
    win = ref_pad[rows, cols].to(torch.int32)               # [nby,nbx,S,S]
    blk = cur.to(torch.int32).reshape(nby, S, nbx, S).permute(0, 2, 1, 3)
    sad = (blk - win).abs().sum(dim=(2, 3), dtype=torch.int32)
    return idx, cost, sad


def motion_decide(cur_y: np.ndarray, ref_y: np.ndarray, width: int,
                  height: int, S: int = 16, R: int = 16, qp: int = 32,
                  subme: int = 2, return_aux: bool = False,
                  bit_depth: int = 8, device=None):
    """Full-search + subpel-refined ME vs one reference frame.

    Returns (mv [nby,nbx,2] quarter-pel int32, cost [nby,nbx] float32
    satd+lambda*bits), numpy. subme: 0 = integer only, 1 = +half, >=2 =
    +quarter (x265 --subme dial). With return_aux, additionally returns
    the phase planes + block geometry for bi-prediction cost evaluation
    (bi_cost, eval_mvs, refine_with_mvp, smooth_mv_field). R <= 24 sweeps
    densely (kernel 5's fused entry); beyond it a sweep of the 2x
    downscaled pair at R/2 finds the centres of a +-7 full-resolution
    window search (kernel 5's window entry). The subpel rounds score
    their candidates on kernel 3's fused gather + SATD.
    """
    device = resolve_device(device)
    ph = -(-height // S) * S
    pw = -(-width // S) * S
    wire = np.int16 if bit_depth > 8 else np.uint8
    cur = np.pad(np.asarray(cur_y).astype(wire),
                 ((0, ph - height), (0, pw - width)), mode="edge")
    ref = np.pad(np.asarray(ref_y).astype(wire),
                 ((0, ph - height), (0, pw - width)), mode="edge")
    nby, nbx = ph // S, pw // S
    N = nby * nbx

    def up(a, dtype=torch.int16):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=device, dtype=dtype)

    lam = np.float32(np.sqrt(0.85 * 2.0 ** ((qp - 12) / 3.0)))
    cur_t = up(cur)

    # --- integer search ---
    if R <= 24:
        n = 2 * R + 1
        dys, dxs = np.mgrid[-R:R + 1, -R:R + 1]
        mvcost = lam * (_mv_bits(4 * dxs.ravel()) + _mv_bits(4 * dys.ravel()))
        idx, cost, _ = _int_search(cur_t, up(np.pad(ref, R, mode="edge")),
                                   up(mvcost, torch.float32), S, R)
        idx = idx.cpu().numpy()
        mv_int = np.stack([(idx % n) - R, (idx // n) - R], axis=-1)  # (dx,dy)
        cost = cost.cpu().numpy()
    else:
        from x265_tpu_torch.engine.planes import pad_dev
        R2 = (R + 1) // 2
        S2 = S // 2
        cur_l = _downscale2(cur_t)
        ref_l = _downscale2(up(ref))
        n2 = 2 * R2 + 1
        dys, dxs = np.mgrid[-R2:R2 + 1, -R2:R2 + 1]
        mvcost2 = lam * (_mv_bits(8 * dxs.ravel())
                         + _mv_bits(8 * dys.ravel()))
        idx2, _, _ = _int_search(cur_l, pad_dev(ref_l, (R2, R2, R2, R2)),
                                 up(mvcost2, torch.float32), S2, R2)
        idx2 = idx2.cpu().numpy()
        mv_half = np.stack([(idx2 % n2) - R2, (idx2 // n2) - R2], axis=-1)
        W_r = 7
        centers = np.clip(mv_half * 2, -(R - W_r), R - W_r).reshape(-1, 2)
        mv_loc, cost_loc = _local_search(
            _to_blocks(cur_t.to(torch.int32), nby, nbx, S),
            up(np.pad(ref, R, mode="edge")), up(centers, torch.int32),
            _block_grid(nby, nbx, device), lam, S, W_r, R)
        mv_int = mv_loc.cpu().numpy().reshape(nby, nbx, 2)
        cost = cost_loc.cpu().numpy().reshape(nby, nbx)

    if subme <= 0:
        mv = (mv_int * 4).astype(np.int32)
        if return_aux:
            raise ValueError("return_aux requires subme >= 1 (phase planes)")
        return mv, np.asarray(cost).astype(np.float32)

    # --- subpel refinement on quarter-pel phase planes ---
    margin = R + 2            # int-pel padding available in the planes
    ref_pad_s = np.pad(ref, ((margin + 3, margin + 4),
                             (margin + 3, margin + 4)), mode="edge")
    planes = _phase_planes(up(ref_pad_s), (1 << bit_depth) - 1)
    bx, by = np.meshgrid(np.arange(nbx), np.arange(nby))
    cur_blocks = _to_blocks(cur_t.to(torch.int32), nby, nbx, S)
    bxy = np.stack([bx.reshape(-1), by.reshape(-1)], axis=1)
    best2, cost2 = _refine_rounds(cur_blocks, planes, (mv_int * 4).reshape(
        N, 2), bxy, torch.zeros((N, 2), dtype=torch.int32, device=device),
        lam, subpel_rounds(subme), S, margin)
    mv = best2.reshape(nby, nbx, 2)
    cost = cost2.reshape(nby, nbx)
    if return_aux:
        aux = dict(planes=planes, cur_blocks=cur_blocks, bxy=bxy,
                   margin=margin, lam=lam)
        return mv.astype(np.int32), cost.astype(np.float32), aux
    return mv.astype(np.int32), cost.astype(np.float32)


def _refine_rounds(cur_blocks, planes, mv, bxy, mvp, lam, rounds, S, margin):
    """The _refine rounds from quarter-pel mv [N,2] (host) at block
    indices bxy [N,2] (host) against the predictor mvp [N,2] (device)
    -> host (best mv [N,2] int32, its cost [N] float32)."""
    dev = cur_blocks.device
    state = torch.from_numpy(np.concatenate(
        [mv, bxy], axis=1).astype(np.int32)).to(dev)
    best = state[:, :2]
    lam = torch.as_tensor(lam, dtype=torch.float32, device=dev)
    cost = None
    for offs in rounds:
        best, cost = _refine(cur_blocks, planes,
                             torch.cat([best, state[:, 2:]], dim=1),
                             torch.from_numpy(offs).to(dev), lam, mvp,
                             S, margin)
    return best.cpu().numpy(), cost.cpu().numpy()


def refine_with_mvp(aux, mv: np.ndarray, mvp: np.ndarray, subme: int = 2):
    """Re-run the subpel refinement + final costing with MVP-relative MV
    bits (two-phase ME: pass 1 finds the motion with a (0,0) prior,
    pass 2 re-costs against the neighborhood predictor so uniform motion
    fields are cheap, like x265's AMVP-based mvcost).

    Returns (mv [nby,nbx,2] qpel, cost [nby,nbx])."""
    nby, nbx = mv.shape[:2]
    N = nby * nbx
    cur_blocks = aux["cur_blocks"]
    rounds = subpel_rounds(subme)
    if subme < 1:
        rounds = [np.array([(0, 0)], dtype=np.int32)]
    mvp_dev = torch.from_numpy(
        mvp.reshape(N, 2).astype(np.int32)).to(cur_blocks.device)
    best, cost = _refine_rounds(cur_blocks, aux["planes"], mv.reshape(N, 2),
                                aux["bxy"], mvp_dev, aux["lam"], rounds,
                                cur_blocks.shape[1], aux["margin"])
    return (best.reshape(nby, nbx, 2).astype(np.int32),
            cost.reshape(nby, nbx).astype(np.float32))


def eval_mvs(aux, mv: np.ndarray) -> np.ndarray:
    """Per-block SATD at arbitrary MVs using a motion_decide aux bundle."""
    cur_blocks = aux["cur_blocks"]
    dev = cur_blocks.device
    satd = _eval_fixed(
        cur_blocks, aux["planes"],
        torch.from_numpy(mv.reshape(-1, 2).astype(np.int32)).to(dev),
        torch.from_numpy(aux["bxy"].astype(np.int32)).to(dev),
        cur_blocks.shape[1], aux["margin"])
    return satd.cpu().numpy()


def smooth_mv_field(mv, cost, aux, lam, group: int = 2,
                    slack_bits: float = 24.0):
    """Unify each group x group block neighborhood onto its modal MV when
    the SATD increase is cheaper than the syntax saved by a merged CU
    (the RD glue that lets the quadtree promote 16->32; x265 gets this
    for free from recursive RDO). Host numpy over eval_mvs, as the
    reference computes it."""
    nby, nbx = mv.shape[:2]
    gy, gx = nby // group, nbx // group
    if gy == 0 or gx == 0:
        return mv
    g = mv[:gy * group, :gx * group].reshape(gy, group, gx, group, 2)
    g = np.moveaxis(g, 3, 2).reshape(gy, gx, group * group, 2)
    # modal mv: the member minimizing summed L1 distance to the others
    d = np.abs(g[:, :, :, None, :] - g[:, :, None, :, :]).sum(axis=(3, 4))
    modal_idx = d.argmin(axis=2)
    modal = np.take_along_axis(
        g, modal_idx[..., None, None], axis=2)[:, :, 0]       # [gy,gx,2]
    cand = np.repeat(np.repeat(modal, group, 0), group, 1)    # [nby',nbx',2]
    full = mv.copy()
    full[:gy * group, :gx * group] = cand
    satd_mode = eval_mvs(aux, full).reshape(nby, nbx)
    satd_best = eval_mvs(aux, mv).reshape(nby, nbx)
    dsum = (satd_mode - satd_best)[:gy * group, :gx * group]
    dsum = dsum.reshape(gy, group, gx, group).sum(axis=(1, 3))
    accept = dsum <= lam * slack_bits
    acc_up = np.repeat(np.repeat(accept, group, 0), group, 1)
    out = mv.copy()
    sel = np.zeros(mv.shape[:2], dtype=bool)
    sel[:gy * group, :gx * group] = acc_up
    out[sel] = full[sel]
    return out


def bi_cost(mv0, aux0, mv1, aux1, S: int = 16, mvp0=None, mvp1=None):
    """Bi-prediction cost per block from two motion_decide aux bundles:
    SATD of the averaged prediction + lambda * mv bits of both MVs
    (MVP-relative when predictors are given)."""
    nby, nbx = mv0.shape[:2]
    cur_blocks = aux0["cur_blocks"]
    dev = cur_blocks.device

    def up(a):
        return torch.from_numpy(
            np.ascontiguousarray(a).astype(np.int32)).to(dev)
    satd = _bi_satd(cur_blocks, aux0["planes"], aux1["planes"],
                    up(mv0.reshape(-1, 2)), up(mv1.reshape(-1, 2)),
                    up(aux0["bxy"]), S, aux0["margin"])
    d0 = mv0 - (mvp0 if mvp0 is not None else 0)
    d1 = mv1 - (mvp1 if mvp1 is not None else 0)
    bits = (_mv_bits(d0.reshape(-1, 2)).sum(1) +
            _mv_bits(d1.reshape(-1, 2)).sum(1))
    cost = satd.cpu().numpy().astype(np.float32) + aux0["lam"] * bits
    return cost.reshape(nby, nbx)


def mv_field_median3(mv: np.ndarray) -> np.ndarray:
    """Per-component 3x3 median of an MV field [nby,nbx,2] (edge-padded)
    — the decision-stage MV predictor (stands in for AMVP, which is only
    defined during the coding walk; x265 motion.cpp uses the real MVP).
    Host numpy, as the reference computes it."""
    p = np.pad(mv, ((1, 1), (1, 1), (0, 0)), mode="edge")
    stack = np.stack([p[dy:dy + mv.shape[0], dx:dx + mv.shape[1]]
                      for dy in range(3) for dx in range(3)])
    return np.median(stack, axis=0).astype(np.int32)


def _edge_pad(a: torch.Tensor, p: int) -> torch.Tensor:
    """Edge-pad the two leading axes of a [H, W, ...] tensor by p."""
    H, W = a.shape[:2]
    ry = torch.arange(-p, H + p, device=a.device).clamp_(0, H - 1)
    rx = torch.arange(-p, W + p, device=a.device).clamp_(0, W - 1)
    return a[ry][:, rx]


def _median3x3_dev(mv):
    """[nby,nbx,2] int -> per-component 3x3 median (edge-padded), device."""
    p = _edge_pad(mv, 1)
    nby, nbx = mv.shape[:2]
    stack = torch.stack([p[dy:dy + nby, dx:dx + nbx]
                         for dy in range(3) for dx in range(3)])
    return torch.sort(stack, dim=0).values[4]


def _int_stage(cur, ref_R, mvcost_flat, S, R):
    """Dense integer search body (one ref). ref_R padded by R. The
    displacement sweep, the mv cost and the first-minimum argmin are one
    fused kernel on a CUDA device (ops.cuda_kernels.sad_sweep_argmin);
    here only the index-to-mv arithmetic is left."""
    n = 2 * R + 1
    idx, _ = sad_sweep_argmin(
        cur.to(torch.int16).contiguous(), ref_R.to(torch.int16).contiguous(),
        mvcost_flat.to(torch.float32).contiguous(), S, R)
    return torch.stack([idx % n - R,
                        torch.div(idx, n, rounding_mode="floor") - R],
                       dim=-1).to(torch.int32)


def _block_grid(nby, nbx, device):
    bx, by = np.meshgrid(np.arange(nbx), np.arange(nby))
    return torch.from_numpy(np.stack(
        [bx.reshape(-1), by.reshape(-1)], axis=1).astype(np.int32)).to(device)


def _to_blocks(plane, nby, nbx, S):
    return (plane.reshape(nby, S, nbx, S).permute(0, 2, 1, 3)
            .reshape(nby * nbx, S, S).contiguous())


class _Band:
    """One tile's block rows [by0, by1) of a frame's search: its rows of
    the current frame, their blocks and block indices, and the replicated
    references on its device. The lanes of a band are the frame's lanes
    by0*nbx .. by1*nbx (row-major blocks)."""

    def __init__(self, device, by0, by1, cur, refs_big, S, nbx):
        self.dev = device
        self.by0, self.by1 = by0, by1
        self.lanes = slice(by0 * nbx, by1 * nbx)
        self.cur = cur[by0 * S:by1 * S].to(device)
        self.blocks = _to_blocks(self.cur, by1 - by0, nbx, S)
        self.bxy = _block_grid(by1 - by0, nbx, device)
        if by0:
            self.bxy[:, 1] += by0          # absolute block rows
        self.refs = refs_big

    def on(self, t):
        return t.to(self.dev)

    def take(self, t):
        """This band's lanes of a frame's lane tensor, on its device."""
        return t[self.lanes].to(self.dev)


def _gather(parts, dev):
    """The bands' results, in band order, on the frame's device."""
    if len(parts) == 1:
        return parts[0]
    return torch.cat([p.to(dev) for p in parts])


def _motion_fused(cur, refs_big, lam, S, R, subme, bd, do_bi,
                  slack=24.0, force_dense=False, tiles=None):
    """cur [H,W] (padded to S multiples); refs_big [nref, H+2P, W+2P]
    edge-padded by P = R+6 (or, under a mesh, {device: that stack} with
    one copy a device of the tiles). Returns (mv [nref,nby,nbx,2] qpel,
    cost [nref,nby,nbx] satd+lam*mvpbits, satd [nref,nby,nbx],
    bi_satd [nby,nbx] (zeros unless do_bi: then the SATD of the average
    of the first two references' predictions)).

    tiles: [(device, by0, by1)] block-row bands (a mesh's tiles,
    me._mesh_tiles) or None for one band of the whole frame on cur's
    device. The per-block stages run band by band on their tile's
    device (kernel 5's sweeps, kernel 3's refine and eval lanes, kernel
    4's bi-prediction SATD); the steps that read across blocks (the
    median predictor, the 2x2 modal smoothing) run on the gathered field
    on cur's device. The results do not depend on the bands."""
    dev = cur.device
    if not isinstance(refs_big, dict):
        refs_big = {_mesh.device_key(dev): refs_big}
    nref = refs_big[_mesh.device_key(dev)].shape[0]
    if do_bi and nref < 2:
        raise ValueError("the bi-prediction search needs two references")
    H, W = cur.shape
    nby, nbx = H // S, W // S
    N = nby * nbx
    P = R + 6
    margin = R + 2
    cur = cur.to(torch.int32)
    maxv = (1 << bd) - 1
    lam = torch.as_tensor(lam, dtype=torch.float32, device=dev)
    bands = [_Band(d, b0, b1, cur, refs_big[_mesh.device_key(d)], S, nbx)
             for d, b0, b1 in (tiles or [(dev, 0, nby)])]

    # --- stage 1: integer search (dense <=24, else 2-level HME;
    # --me full forces the dense sweep at any range) ---
    mv_int = []
    if R <= 24 or force_dense:
        with scope("me.dense"):
            dys, dxs = np.mgrid[-R:R + 1, -R:R + 1]
            mvcost = torch.from_numpy(
                (_mv_bits(4 * dxs.ravel()) + _mv_bits(4 * dys.ravel()))
                .astype(np.float32)).to(dev)
            for r in range(nref):
                mv_int.append(_gather([_int_stage(
                    b.cur, b.refs[r, P - R + b.by0 * S:P + b.by1 * S + R,
                                  P - R:P + W + R],
                    b.on(lam * mvcost), S, R) for b in bands], dev))
    else:
        from x265_tpu_torch.engine.planes import pad_dev
        R2 = (R + 1) // 2
        S2 = S // 2
        dys, dxs = np.mgrid[-R2:R2 + 1, -R2:R2 + 1]
        mvcost2 = torch.from_numpy(
            (_mv_bits(8 * dxs.ravel()) + _mv_bits(8 * dys.ravel()))
            .astype(np.float32)).to(dev)
        W_r = 7
        cur_l = [_downscale2(b.cur) for b in bands]
        for r in range(nref):
            ref_l = _PerDevice()   # the padded half-size reference
            parts = []
            for b, cl in zip(bands, cur_l):
                rb = b.refs[r]
                if b.dev not in ref_l:
                    ref_l[b.dev] = pad_dev(_downscale2(rb[P:P + H, P:P + W]),
                                           (R2, R2, R2, R2))
                mvh = _int_stage(
                    cl, ref_l[b.dev][b.by0 * S2:b.by1 * S2 + 2 * R2],
                    b.on(lam * mvcost2), S2, R2)
                centers = (mvh * 2).clamp(-(R - W_r), R - W_r).reshape(-1, 2)
                ref_R = rb[P - R:P + H + R, P - R:P + W + R]
                mv_loc, _ = _local_search(b.blocks, ref_R, centers, b.bxy,
                                          b.on(lam), S, W_r, R)
                parts.append(mv_loc)
            mv_int.append(_gather(parts, dev).reshape(nby, nbx, 2))

    # --- stage 2: phase planes + subpel/MVP/smoothing per ref ---
    rounds = [torch.from_numpy(r).to(dev) for r in subpel_rounds(subme)]

    def refine_ref(planes_r, mv0):
        # MVP from the integer-search field directly
        best = mv0.reshape(N, 2) * 4
        mvp = _median3x3_dev(mv0 * 4).reshape(N, 2)

        def band_rounds(b):
            planes, p, bb = planes_r[b.dev], b.take(mvp), b.take(best)
            for offs in rounds:
                bb, _ = _refine(b.blocks, planes,
                                torch.cat([bb, b.bxy], dim=1),
                                b.on(offs), b.on(lam), p, S, margin)
            return (bb, _eval_fixed(b.blocks, planes, p, b.bxy, S, margin),
                    _eval_fixed(b.blocks, planes, bb, b.bxy, S, margin))
        outs = [band_rounds(b) for b in bands]
        best, satd_mvp, satd_cur = (_gather([o[k] for o in outs], dev)
                                    for k in range(3))
        # snap-to-predictor: taking the predictor exactly when its SATD
        # is within the saved bits lets the writer's merge detection fire
        bits_now = _mv_bits_t((best - mvp).abs()).sum(dim=1)
        snap = (satd_mvp.to(torch.float32)
                <= satd_cur.to(torch.float32) + lam * (bits_now + 6.0))
        best = torch.where(snap[:, None], mvp, best)
        # 2x2 modal smoothing
        mvf = best.reshape(nby, nbx, 2)
        gy, gx = nby // 2, nbx // 2
        # axis order as in the JAX package (moveaxis(g, 3, 2) and then a
        # flat reshape): the four "members" of a group are taken from
        # that flattening, not from the group's own 2x2 blocks. Streams
        # are compared byte for byte, so the order is kept as it is.
        g = mvf[:gy * 2, :gx * 2].reshape(gy, 2, gx, 2, 2)
        g = g.permute(0, 1, 3, 2, 4).reshape(gy, gx, 4, 2)
        d = (g[:, :, :, None, :] - g[:, :, None, :, :]).abs().sum(dim=(3, 4))
        mi = first_argmin(d, 2)
        modal = torch.gather(
            g, 2, mi[..., None, None].expand(gy, gx, 1, 2))[:, :, 0]
        cand = modal.repeat_interleave(2, 0).repeat_interleave(2, 1)
        full = mvf.clone()
        full[:gy * 2, :gx * 2] = cand
        full_l = full.reshape(N, 2)
        outs = [(_eval_fixed(b.blocks, planes_r[b.dev], b.take(full_l),
                             b.bxy, S, margin),
                 _eval_fixed(b.blocks, planes_r[b.dev], b.take(best),
                             b.bxy, S, margin)) for b in bands]
        satd_mode, satd_best = (_gather([o[k] for o in outs], dev)
                                for k in range(2))
        dsum = (satd_mode - satd_best).reshape(nby, nbx)
        dsum = dsum[:gy * 2, :gx * 2].reshape(gy, 2, gx, 2).sum(
            dim=(1, 3), dtype=torch.int32)
        acc = dsum.to(torch.float32) <= lam * slack
        accf = acc.repeat_interleave(2, 0).repeat_interleave(2, 1)
        sel = torch.zeros((nby, nbx), dtype=torch.bool, device=dev)
        sel[:gy * 2, :gx * 2] = accf
        mv_out = torch.where(sel[..., None], full, mvf)
        satd_out = torch.where(sel.reshape(-1), satd_mode, satd_best)
        bits = _mv_bits_t((mv_out.reshape(N, 2) - mvp).abs()).sum(dim=1)
        cost_out = satd_out.to(torch.float32) + lam * bits
        return mv_out, cost_out.reshape(nby, nbx), satd_out.reshape(nby, nbx)

    mvs, costs, satds, planes = [], [], [], []
    for r in range(nref):
        planes_r = _PerDevice()    # the phase planes, one set a device
        for b in bands:
            if b.dev not in planes_r:
                planes_r[b.dev] = _phase_planes(
                    b.refs[r, P - margin - 3:P + H + margin + 4,
                           P - margin - 3:P + W + margin + 4], maxv)
        m, c, s = refine_ref(planes_r, mv_int[r])
        mvs.append(m)
        costs.append(c)
        satds.append(s)
        if do_bi and r < 2:
            planes.append(planes_r)
    if do_bi:
        mv0, mv1 = mvs[0].reshape(N, 2), mvs[1].reshape(N, 2)
        bi = _gather([_bi_satd(b.blocks, planes[0][b.dev], planes[1][b.dev],
                               b.take(mv0), b.take(mv1), b.bxy, S, margin)
                      for b in bands], dev).reshape(nby, nbx)
    else:
        bi = torch.zeros((nby, nbx), dtype=torch.int32, device=dev)
    return torch.stack(mvs), torch.stack(costs), torch.stack(satds), bi


class _PerDevice(dict):
    """A dict keyed by device, whatever name the device is given by."""

    def __getitem__(self, d):
        return super().__getitem__(_mesh.device_key(d))

    def __setitem__(self, d, v):
        super().__setitem__(_mesh.device_key(d), v)

    def __contains__(self, d):
        return super().__contains__(_mesh.device_key(d))


def _mesh_tiles(mesh, nby):
    """The block-row bands [(device, by0, by1)] of a frame of nby block
    rows over the mesh's tiles, or None (one band, unsharded) without a
    mesh or when nby does not divide by the tile count: the JAX package's
    _mesh_put shards the current frame only when its padded height
    divides by S * n_tiles."""
    if mesh is None:
        return None
    devs = list(mesh.devices.flat)
    n = len(devs)
    if nby % n:
        return None
    k = nby // n
    return [(d, i * k, (i + 1) * k) for i, d in enumerate(devs)]


def _mesh_refs(ref_ys, P, ph, pw, height, width, device, tiles):
    """The search-layout references on every device of the bands (the
    JAX package's replicated upload): {device: [nref, ...] stack}; on a
    mesh that names one card several times, one stack."""
    refs = _PerDevice()
    for d in [device] + [t[0] for t in (tiles or ())]:
        if d not in refs:
            refs[d] = torch.stack([_me_ref_upload(r, P, ph, pw, height,
                                                  width, d) for r in ref_ys])
    return refs


def _cur_upload(cur_y, bit_depth, ph, pw, device):
    """Source luma on the device, padded to block multiples (shared
    upload: the same plane feeds analysis and residual)."""
    from x265_tpu_torch.engine.planes import pad_dev
    from x265_tpu_torch.utils import devcache
    arr = np.asarray(cur_y)
    H, W = arr.shape
    return pad_dev(devcache.src_plane(arr, bit_depth, device),
                   (0, ph - H, 0, pw - W))


def motion_fused(cur_y, ref_ys, width, height, S=16, R=57, qp=32,
                 subme=2, bit_depth=8, do_bi=False, slack=24.0,
                 force_dense=False, mesh=None, device=None):
    """Host wrapper: all refs' motion search for one frame.

    cur_y [H,W]; ref_ys: list of reference luma planes (numpy) or
    device handles (FramePlanes/MELuma). mesh: a parallel.mesh.Mesh
    whose tiles take the frame's block rows in bands (when the padded
    height divides by S * n_tiles; else the call runs unsharded), with
    the references replicated on each tile's device; the results are
    those of mesh=None, gathered on `device`.
    Returns numpy (mv [nref,nby,nbx,2], cost [nref,nby,nbx], satd, bi).
    """
    device = resolve_device(device)
    ph = -(-height // S) * S
    pw = -(-width // S) * S
    P = R + 6
    tiles = _mesh_tiles(mesh, ph // S)
    refs = _mesh_refs(ref_ys, P, ph, pw, height, width, device, tiles)
    cur = _cur_upload(cur_y, bit_depth, ph, pw, device)
    lam = np.float32(np.sqrt(0.85 * 2.0 ** ((qp - 12) / 3.0)))
    mv, cost, satd, bi = _motion_fused(
        cur, refs, lam, S, R, max(1, subme), bit_depth, do_bi,
        float(slack), bool(force_dense), tiles)
    return (mv.cpu().numpy(), cost.cpu().numpy(), satd.cpu().numpy(),
            bi.cpu().numpy())


def motion_fused_frames(cur_list, ref_ys, width, height, S=16, R=57,
                        qps=None, subme=2, bit_depth=8, do_bi=False,
                        slack=24.0, force_dense=False, device=None):
    """Motion search for SEVERAL frames against the same reference set
    (the mini-GOP's leaf Bs all predict from the same two anchors). The
    JAX package batches the frames on one axis; here each frame is one
    _motion_fused call at that frame's lambda, which the reference forms
    in float32 throughout (not rounded once from float64 as
    motion_fused does).

    Returns per-frame tuples [(mv, cost, satd, bi)], numpy.
    """
    device = resolve_device(device)
    K = len(cur_list)
    ph = -(-height // S) * S
    pw = -(-width // S) * S
    P = R + 6
    refs = torch.stack([_me_ref_upload(r, P, ph, pw, height, width, device)
                        for r in ref_ys])
    if qps is None:
        qps = [32] * K
    lams = np.sqrt(
        0.85 * 2.0 ** ((np.asarray(qps, np.float32) - 12) / 3.0)
    ).astype(np.float32)
    out = []
    for k in range(K):
        cur = _cur_upload(cur_list[k], bit_depth, ph, pw, device)
        mv, cost, satd, bi = _motion_fused(
            cur, refs, lams[k], S, R, max(1, subme), bit_depth, do_bi,
            float(slack), bool(force_dense))
        out.append((mv.cpu().numpy(), cost.cpu().numpy(),
                    satd.cpu().numpy(), bi.cpu().numpy()))
    return out


def _me_ref_upload(r, P, ph, pw, height, width, device):
    """Search-layout reference (int16): a device-resident handle pads ON
    DEVICE (FramePlanes/MELuma.dev_luma_me), and a copy of it on another
    device (a mesh's tile) is cached as an upload is; a host plane is
    uploaded once per anchor and device (identity-keyed cache) and padded
    on the device."""
    from x265_tpu_torch.engine.planes import pad_dev
    from x265_tpu_torch.utils import devcache
    if hasattr(r, "dev_luma_me"):
        t = r.dev_luma_me(P, ph, pw)
        if _mesh.device_key(t.device) == _mesh.device_key(device):
            return t
        return devcache.get_or(("me_ref", id(r), P, ph, pw, str(device)),
                               r, lambda: t.to(device))

    def build():
        a = torch.from_numpy(np.ascontiguousarray(
            np.asarray(r).astype(np.int16))).to(device)
        return pad_dev(a, (P, P + ph - height, P, P + pw - width))
    return devcache.get_or(("me_ref", id(r), P, ph, pw, str(device)), r,
                           build)


# ---------------------------------------------------------------------------
# Motion coherence pass (decision-stage merge/skip emulation): evaluate a
# handful of frame-dominant motion tuples for EVERY block in one batched
# pass and adopt them where the AMVP->merge/skip rate saving wins (x265
# RD-costs the real merge candidates per CU, analysis.cpp:1914).
# ---------------------------------------------------------------------------

def _tuple_satd(cur, refs0_big, refs1_big, dirs, r0s, r1s, mv0s, mv1s,
                S, P, K, bd, y0=0):
    """SATD of every SxS block under K fixed motion tuples.

    cur [Hc,W]: rows y0 .. y0+Hc of a frame H rows tall (the whole frame,
    or a mesh tile's band of it); refs{0,1}_big [nref, H+2P, W+2P]
    edge-padded by P (the motion_fused upload layout); dirs (1/2/3),
    r0s/r1s list indices, mv0s/mv1s quarter-pel pairs — host sequences
    of length K. Returns [K, Hc/S, W/S] int32: the whole frame's SATDs of
    these blocks.
    """
    Hc, W = cur.shape
    H = refs0_big.shape[1] - 2 * P
    nby, nbx = Hc // S, W // S
    cur_blocks = _to_blocks(cur.to(torch.int32), nby, nbx, S)
    f = LUMA_FILTERS                       # [4, 8] (tap 3 = base sample)
    maxv = (1 << bd) - 1

    def plane_pred(refs_big, r, mvx, mvy):
        """Whole-frame 8-tap qpel prediction at one fixed MV."""
        nr, Hb, Wb = refs_big.shape
        r = min(max(int(r), 0), nr - 1)

        def start(i, dim, size):
            # lax.dynamic_slice: a negative start counts from the end,
            # then the start is clamped into the plane
            return min(max(i + dim if i < 0 else i, 0), dim - size)
        ix = start(P + (mvx >> 2) - 3, Wb, W + 7)
        iy = start(P + (mvy >> 2) - 3, Hb, H + 7) + y0
        win = refs_big[r, iy:iy + Hc + 7, ix:ix + W + 7].to(torch.int32)
        fx = f[mvx & 3]
        fy = f[mvy & 3]
        hor = torch.zeros((Hc + 7, W), dtype=torch.int32, device=cur.device)
        for t in range(8):
            if int(fx[t]):
                hor += int(fx[t]) * win[:, t:t + W]
        out = torch.zeros((Hc, W), dtype=torch.int32, device=cur.device)
        for t in range(8):
            if int(fy[t]):
                out += int(fy[t]) * hor[t:t + Hc, :]
        return ((out + 2048) >> 12).clamp_(0, maxv)

    preds = []
    for k in range(K):
        d = int(dirs[k])
        if d == 3:
            p0 = plane_pred(refs0_big, r0s[k], int(mv0s[k][0]),
                            int(mv0s[k][1]))
            p1 = plane_pred(refs1_big, r1s[k], int(mv1s[k][0]),
                            int(mv1s[k][1]))
            pred = (p0 + p1 + 1) >> 1
        elif d == 1:
            pred = plane_pred(refs0_big, r0s[k], int(mv0s[k][0]),
                              int(mv0s[k][1]))
        else:
            pred = plane_pred(refs1_big, r1s[k], int(mv1s[k][0]),
                              int(mv1s[k][1]))
        preds.append(_to_blocks(pred, nby, nbx, S))
    # the K candidates' blocks in one SATD launch
    return satd8_batched(cur_blocks.repeat(K, 1, 1),
                         torch.cat(preds)).reshape(K, nby, nbx)


def tuple_satd(cur_y, ref0_ys, ref1_ys, cands, width, height, S=16,
               R=57, bit_depth=8, mesh=None, device=None):
    """Host wrapper for _tuple_satd: cands is a list of
    (dir, r0, r1, (mv0x, mv0y), (mv1x, mv1y)) tuples (any count).
    Reference uploads hit the motion_fused device cache. mesh: as
    motion_fused's (block-row bands over the tiles, references
    replicated; unsharded when the padded height does not divide by
    S * n_tiles), with the results of mesh=None.
    Returns numpy satd [len(cands), nby, nbx]."""
    device = resolve_device(device)
    ph = -(-height // S) * S
    pw = -(-width // S) * S
    cur = _cur_upload(cur_y, bit_depth, ph, pw, device)
    P = R + 6
    tiles = _mesh_tiles(mesh, ph // S) or [(device, 0, ph // S)]
    refs0 = _mesh_refs(ref0_ys, P, ph, pw, height, width, device, tiles)
    refs1 = (_mesh_refs(ref1_ys, P, ph, pw, height, width, device, tiles)
             if ref1_ys else None)
    cands = list(cands)
    outs = []
    for d, by0, by1 in tiles:
        r0 = refs0[d]
        outs.append(_tuple_satd(
            cur[by0 * S:by1 * S].to(d), r0,
            refs1[d] if refs1 is not None else r0[:1],
            [c[0] for c in cands], [c[1] for c in cands],
            [c[2] for c in cands], [c[3] for c in cands],
            [c[4] for c in cands], S, P, len(cands), bit_depth,
            y0=by0 * S).cpu())
    return torch.cat(outs, dim=1).numpy()


def dominant_tuples(dir_blk, mv_blk, ref_blk, inter_blk, max_cands=4):
    """Frame-dominant motion tuples from per-block decisions: the
    most-frequent (dir, ref, mv0, mv1) combinations among inter blocks.
    Returns a list of (dir, r0, r1, (mv0x,mv0y), (mv1x,mv1y)), most
    frequent first (possibly empty)."""
    sel = inter_blk.astype(bool)
    if not sel.any():
        return []
    flat = np.concatenate(
        [dir_blk[sel][:, None], ref_blk[sel][:, None],
         mv_blk[sel].reshape(-1, 4)], axis=1)
    uniq, cnt = np.unique(flat, axis=0, return_counts=True)
    order = np.argsort(-cnt)
    out = []
    for i in order[:max_cands]:
        d, r, x0, y0, x1, y1 = (int(v) for v in uniq[i])
        out.append((d, r, 0, (x0, y0), (x1, y1)))
    return out
