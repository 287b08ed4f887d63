"""The slow preset's three mechanisms against the benchmark's plain
reference (encbench/reference/{rdoq,rqt,dense}.py), on the CPU, at small
sizes from seeded random inputs: the port's RDOQ levels exactly, the
explicit inter RQT's split wherever its two costs differ by more than
float32 rounding, and the dense integer search's motion vectors and SADs
exactly, its float32 costs within rounding of the reference's float64."""
import numpy as np
import pytest
import torch

from encbench.reference import dense, rdoq, rqt
from x265_tpu_torch.engine import me
from x265_tpu_torch.hevc.rate_model import slice_rate_consts
from x265_tpu_torch.models import inter_residual as ir
from x265_tpu_torch.models.residual import (_tq_chain, fwd_transform_b,
                                            quantize_b, rdoq_b)
from x265_tpu_torch.ops.cuda_kernels import sad_sweep_argmin



def _residuals(rng, N, n, amp):
    """Residual blocks of amplitudes up to `amp`: a faint noise
    everywhere; in every other block a stronger one in one random
    quadrant (so both RQT choices occur), elsewhere over the block."""
    r = rng.integers(-2, 3, (N, n, n))
    m = n // 2
    for i in range(N):
        a = int(rng.integers(2, amp + 1))
        if i % 2:
            r[i] += rng.integers(-a, a + 1, (n, n))
            continue
        q = int(rng.integers(0, 4))
        oy, ox = (q // 2) * m, (q % 2) * m
        r[i, oy:oy + m, ox:ox + m] += rng.integers(-a, a + 1, (m, m))
    return torch.from_numpy(r.astype(np.int32))


@pytest.mark.parametrize("slice_type,qp", [(2, 22), (1, 30), (0, 37),
                                           (1, 0), (0, 51)])
def test_rate_constants_equal(slice_type, qp):
    assert np.array_equal(np.array(rdoq.rate_consts(slice_type, qp)),
                          slice_rate_consts(slice_type, qp))


@pytest.mark.parametrize("model", ["static", "estbit"])
@pytest.mark.parametrize("plane,psy", [("luma", 0), ("luma", 256),
                                       ("chroma", 0)])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_rdoq_levels_exact(n, plane, psy, model):
    rng = np.random.default_rng([n, psy, len(plane), len(model)])
    N = 16
    resi = _residuals(rng, N, n, 90)
    qp = torch.from_numpy(rng.integers(12, 46, N).astype(np.int32))
    coeff = fwd_transform_b(resi, n, False, 8)
    lvl = quantize_b(coeff, qp, n, False, 8)
    consts = (None if model == "static" else
              slice_rate_consts(1, 32)[0 if plane == "luma" else 1].copy())
    got = rdoq_b(coeff, lvl, qp, n, 8, consts=consts, psy_fx=psy)
    changed = 0
    for i in range(N):
        want = rdoq.rdoq_block(coeff[i], lvl[i], int(qp[i]), n, 8, consts,
                               psy)
        assert torch.equal(got[i].to(torch.int64), want), i
        changed += int((want != lvl[i].to(torch.int64)).sum())
    if model == "estbit":
        # RDOQ moved levels: the test has teeth (the static model's
        # 0.4-scaled lambda moves few, none on some of these draws)
        assert changed > 0


@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("rdoq_on,psy", [(False, 0), (True, 256)])
def test_rqt_split_outside_ties(n, rdoq_on, psy):
    """The split choice of models/inter_residual._rqt_split on the
    transform chains _inter_class_body runs (one TU, four quadrants),
    luma and both chroma planes, against the reference's float64 costs."""
    rng = np.random.default_rng([n, psy])
    N, hs = 24, n // 2
    res = [_residuals(rng, N, n, 40), _residuals(rng, N, hs, 20),
           _residuals(rng, N, hs, 20)]
    qpy = torch.from_numpy(rng.integers(22, 38, N).astype(np.int32))
    kk = torch.from_numpy(slice_rate_consts(1, 30).astype(np.int32))
    zs = torch.zeros(N, dtype=torch.int32)
    one, quads = [], []
    for p, r in enumerate(res):
        size, pfx = (n, psy) if p == 0 else (hs, 0)
        k = kk[0 if p == 0 else 1] if rdoq_on else None
        lv, rr, _ = _tq_chain(r, qpy, zs, size, False, False, 8, True,
                              rdoq_on, False, False, k, pfx)
        one.append((lv, rr))
        ql, qr, _ = ir._tq_quads(r, qpy, size // 2, N, 8, True, rdoq_on,
                                 False, False, k, pfx)
        quads.append((ql, qr))
    got = ir._rqt_split(tuple(res), tuple(one), tuple(quads), qpy, kk)
    splits = compared = 0
    for i in range(N):
        want, a, b = rqt.split_decision(
            [r[i] for r in res], [(lv[i], rr[i]) for lv, rr in one],
            [(lv[i], rr[i]) for lv, rr in quads], int(qpy[i]),
            kk[0].tolist(), kk[1].tolist())
        splits += bool(want)
        if abs(a - b) > rqt.RQT_TIE * max(abs(a), abs(b)):
            compared += 1
            assert bool(got[i]) == want, (i, a, b)
    assert compared >= N - 2 and 0 < splits < N


def _plane_pair(seed, W, H, R, shift):
    """A textured current plane and its reference padded by R, the
    content moved by `shift` = (dx, dy) whole pels, with noise; the
    padding is more of the texture, so that every block has its match."""
    rng = np.random.default_rng(seed)
    big = rng.integers(0, 256, (H + 256, W + 256)).astype(np.float64)
    for _ in range(2):           # smooth so the SAD surface has a slope
        big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)
               + np.roll(big, (1, 1), (0, 1))) / 4
    dx, dy = shift
    cur = big[128:128 + H, 128:128 + W]
    ref_pad = big[128 - dy - R:128 - dy + H + R, 128 - dx - R:128 - dx + W + R]
    noise = rng.integers(-2, 3, ref_pad.shape)
    return (cur.astype(np.int16),
            np.clip(ref_pad + noise, 0, 255).astype(np.int16))


@pytest.mark.parametrize("R,shift", [(8, (5, -3)), (57, (-38, 29))])
def test_dense_search_exact(R, shift):
    S, W, H = 16, 64, 48
    cur, ref_pad = _plane_pair(R, W, H, R, shift)
    lam = np.float32(np.sqrt(0.85 * 2.0 ** ((32 - 12) / 3.0)))
    dys, dxs = np.mgrid[-R:R + 1, -R:R + 1]
    mvcost = torch.from_numpy(
        (me._mv_bits(4 * dxs.ravel()) + me._mv_bits(4 * dys.ravel()))
        .astype(np.float32))
    lam_cost = torch.tensor(lam) * mvcost
    cur_t, ref_t = torch.from_numpy(cur), torch.from_numpy(ref_pad)
    mv = me._int_stage(cur_t, ref_t, lam_cost, S, R)
    _, cost = sad_sweep_argmin(cur_t, ref_t, lam_cost, S, R)
    moved = 0
    for by in range(H // S):
        for bx in range(W // S):
            (dx, dy), sad, c64 = dense.search_block(cur, ref_pad, bx, by, S,
                                                    R, float(lam))
            assert tuple(mv[by, bx].tolist()) == (dx, dy), (bx, by)
            c32 = float(cost[by, bx])
            # the kernel's float32 cost: two roundings of 2^-24 relative
            assert abs(c32 - c64) <= 2.0 ** -23 * c64, (c32, c64)
            port_sad = round(c32 - float(lam_cost[(dy + R) * (2 * R + 1)
                                                  + dx + R]))
            assert port_sad == sad
            moved += (dx, dy) == shift
    assert moved >= (H // S) * (W // S) // 2
