"""The port's RD evaluation (models/rdo.py, models/intra_rdo.py and
hevc/rate_model.rate_bits_j) against the JAX package's on the same numpy
inputs: the per-coefficient and per-TB rates, the merge adoption of every
16x16 block (rd_adopt16), the 32x32 and 64x64 promotions (rd_promote32,
rd_promote) and the intra 32x32 promotion (rd_intra_promote32).

Tolerance: the decisions (adopted tuples, promoted groups, unified
motion, chosen intra modes) are exact; no flip was seen over these cases.
The costs are float32 and agree to 4e-7 relative: the port sums SSE and
Q15 rates as integers and converts once, which equals the reference
whenever its float32 sums are exact (a TB's rate below 512 bits); above
that the reference's summation order rounds differently by a few ulp."""
import copy

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax import enable_x64

from x265_tpu.api import params as JP
from x265_tpu.engine.me import dominant_tuples
from x265_tpu.hevc import rate_model as jrm
from x265_tpu.models import intra_rdo as jir
from x265_tpu.models import rdo as jrdo
from x265_tpu.models.intra_frame import decide_intra_frame_tpu
from x265_tpu_torch.api import params as TP
from x265_tpu_torch.engine.planes import FramePlanes
from x265_tpu_torch.hevc import rate_model as trm
from x265_tpu_torch.models import intra_rdo as tir
from x265_tpu_torch.models import rdo as trdo
from x265_tpu_torch.utils.testclip import make_clip
import torch_port_util  # noqa: F401  (one torch thread)

W, H, PAD = 192, 128, 80
COST_RTOL = 4e-7


def T(a):
    return torch.from_numpy(np.array(a))


def _params(pkg, qp):
    p = pkg.param_default_preset("medium", "zerolatency")
    pkg.param_parse(p, "qp", str(qp))
    p.width, p.height = W, H
    return p


def _scene(seed):
    """(current picture, two earlier pictures as references): the clip
    moves by (5, 2) pels a frame, so the true L0 motion of the current
    picture is (20, 8) quarter pels against ref 0 and twice that against
    ref 1."""
    frames = make_clip(W, H, 3, seed=seed)
    cur = frames[2]
    refs = [frames[1], frames[0]]
    jrefs = [tuple(np.pad(np.asarray(pl).astype(np.int16),
                          PAD >> (0 if i == 0 else 1), mode="edge")
                   for i, pl in enumerate(r)) for r in refs]
    trefs = [FramePlanes(host=tuple(np.asarray(pl, np.int32) for pl in r),
                         device="cpu") for r in refs]
    return cur, jrefs, trefs


def _motion(seed, nby, nbx):
    """A jittered field around the true motion, ref 0 and ref 1 mixed,
    with a few intra blocks."""
    rng = np.random.default_rng(seed)
    ref = (rng.random((nby, nbx)) < 0.25).astype(np.int32)
    mv = np.zeros((nby, nbx, 2, 2), np.int32)
    mv[..., 0, 0] = 20 * (1 + ref) + rng.integers(-2, 3, (nby, nbx))
    mv[..., 0, 1] = 8 * (1 + ref) + rng.integers(-2, 3, (nby, nbx))
    inter = rng.random((nby, nbx)) < 0.9
    return np.ones((nby, nbx), np.int32), mv, ref, inter


def test_rate_bits_j():
    rng = np.random.default_rng(0)
    lv = rng.integers(-70000, 70000, 4096).astype(np.int32)
    lv[:64] = np.arange(-32, 32)
    for init_type, qp in ((0, 22), (2, 37)):
        k = jrm.rdoq_rate_consts(init_type, qp)
        want = np.asarray(jrm.rate_bits_j(jnp.asarray(lv), jnp.asarray(k[0])))
        got = trm.rate_bits_j(T(lv), T(k[0])).numpy()
        assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("S", [4, 8, 16, 32])
def test_tb_rate_bits_j(S):
    """Sparse and dense TBs: exact while a TB's rate is below 512 bits,
    within COST_RTOL above."""
    rng = np.random.default_rng(S)
    N = 64
    dens = min(0.15, 24.0 / (S * S))
    lvl = rng.integers(-3, 4, (N, S, S)) * (rng.random((N, S, S)) < dens)
    lvl[:8] = 0
    lvl[8:12, 0, 0] = [1, -2, 7, 300]
    lvl[-8:] = rng.integers(-40, 41, (8, S, S))
    lvl = lvl.astype(np.int32)
    k = jrm.rdoq_rate_consts(2, 30)
    with enable_x64():
        want = np.asarray(jrdo._tb_rate_bits_j(jnp.asarray(lvl),
                                               jnp.asarray(k[1])))
    got = trdo._tb_rate_bits_j(T(lvl), T(k[1])).numpy()
    small = want < 512
    assert small.sum() >= N // 2
    assert np.array_equal(got[small], want[small])
    np.testing.assert_allclose(got, want, rtol=COST_RTOL, atol=0)


@pytest.mark.parametrize("qp", [22, 37])
def test_rd_adopt16(qp):
    cur, jrefs, trefs = _scene(qp)
    nby, nbx = H // 16, W // 16
    dir_blk, mv_blk, ref_blk, inter = _motion(qp, nby, nbx)
    cands = dominant_tuples(dir_blk, mv_blk, ref_blk, inter)
    assert len(cands) == 4
    with enable_x64():
        want = jrdo.rd_adopt16(cur, jrefs, [], inter, mv_blk, dir_blk,
                               ref_blk, cands, qp, _params(JP, qp))
    got = trdo.rd_adopt16(cur, trefs, [], inter, mv_blk, dir_blk, ref_blk,
                          cands, qp, _params(TP, qp), device="cpu")
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))
    assert 0 < want[3].sum() < inter.sum()       # both outcomes occur


def _promo_inputs(seed, n):
    nby, nbx = H // 16, W // 16
    dir_blk, mv_blk, ref_blk, _ = _motion(seed, nby, nbx)
    hn, wn = H // n, W // n
    ys, xs = np.divmod(np.arange(hn * wn), wn)
    cand = np.stack([ys, xs], 1)
    k = n // 16                       # 16x16 blocks per side of a group
    m = k // 2
    sub = [(0, 0), (0, m), (m, 0), (m, m)]
    mv4 = np.stack([mv_blk[ys * k + dy, xs * k + dx] for dy, dx in sub], 1)
    # ref and dir follow the group (eligibility needs them uniform)
    ref_i = ref_blk[ys * k, xs * k]
    mv4[:len(ys) // 3] = mv4[:len(ys) // 3, :1]   # some uniform groups
    return cand, mv4.astype(np.int32), dir_blk[ys * k, xs * k], ref_i


@pytest.mark.parametrize("n,qp", [(32, 22), (32, 37), (64, 30), (64, 22)])
def test_rd_promote(n, qp):
    cur, jrefs, trefs = _scene(n + qp)
    cand, mv4, dirm, ref_i = _promo_inputs(qp, n)
    bias = (np.array([[20, 8], [0, 0]], np.int32), 1)
    for mv_bias, bias_dir in ((None, None), bias):
        with enable_x64():
            jp, jmv = jrdo.rd_promote(cur, jrefs, [], cand, mv4, dirm, ref_i,
                                      qp, _params(JP, qp), n=n,
                                      mv_bias=mv_bias, bias_dir=bias_dir)
        tp, tmv = trdo.rd_promote(cur, trefs, [], cand, mv4, dirm, ref_i,
                                  qp, _params(TP, qp), n=n, mv_bias=mv_bias,
                                  bias_dir=bias_dir, device="cpu")
        assert np.array_equal(tp, np.asarray(jp))
        assert np.array_equal(tmv, jmv)
    if n == 32:
        assert 0 < tp.sum() < len(tp)


def test_rd_promote_costs_agree():
    """The two cost vectors of rd_promote32 themselves."""
    n, qp = 32, 30
    cur, jrefs, trefs = _scene(5)
    cand, mv4, dirm, ref_i = _promo_inputs(5, n)
    G = len(cand)
    xy = np.stack([cand[:, 1] * n, cand[:, 0] * n], 1).astype(np.int32)
    oh1 = np.full(G, 6, np.float32)
    oh4 = np.full(G, 34, np.float32)
    rk = jrm.rdoq_rate_consts(2, qp)
    kw = dict(n=n, bd=8, sdh=True, do_rdoq=False, scaling=False, pad=PAD,
              cb_off=0, cr_off=0, psy=2.0)
    src = [np.asarray(pl).astype(np.int16) for pl in cur]
    r0 = [np.stack([r[i] for r in jrefs]) for i in range(3)]
    r1 = [np.zeros((1,) + a.shape[1:], np.int16) for a in r0]
    args = (xy, mv4, mv4[:, 0], dirm, ref_i, np.full(G, qp, np.int32),
            oh1, oh4, rk)
    with enable_x64():
        want = jrdo._promo_costs(*map(jnp.asarray, src + r0 + r1),
                                 *map(jnp.asarray, args), **kw)
    got = trdo._promo_costs(*map(T, src + r0), None, None, None,
                            *map(T, args), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=COST_RTOL, atol=0)


@pytest.mark.parametrize("qp,psy", [(22, 2.0), (37, 2.0), (30, 0.0)])
def test_rd_intra_promote32(qp, psy):
    frames = make_clip(W, H, 1, seed=qp)
    cur = frames[0]
    # flat and gradient regions next to the texture, so both trees win
    y = cur[0].copy()
    y[:64, :64] = 120
    y[64:, 128:] = (np.arange(64)[:, None] + np.arange(64)[None, :]
                    ).astype(np.uint8)
    y[64:, :64] = np.random.default_rng(qp).integers(0, 256, (64, 64))
    cur = (y, cur[1], cur[2])
    dec = decide_intra_frame_tpu(y, W, H, cu_log2=4, fast=False, psy=psy)
    jdec = copy.deepcopy(dec)
    tdec = copy.deepcopy(dec)
    jpar, tpar = _params(JP, qp), _params(TP, qp)
    jpar.psy_rd = tpar.psy_rd = psy
    n_j = jir.rd_intra_promote32(cur, jdec, qp, jpar)
    n_t = tir.rd_intra_promote32(cur, tdec, qp, tpar, device="cpu")
    assert n_t == n_j
    for k in ("cu_log2_map", "luma_mode8", "chroma_mode8"):
        assert np.array_equal(getattr(tdec, k), getattr(jdec, k))
    # the reference promotes every eligible group of such pictures; the
    # chosen 32x32 modes differ between the flat, gradient and textured
    # groups
    assert n_j > 0 and len(np.unique(jdec.luma_mode8[:, :24])) > 1


@pytest.mark.parametrize("case", ["ties", "wide", "single", "no_inter"])
def test_dominant_mv_equals_the_jax_package(case):
    """The promotions' unification bias (Encoder._dominant_mv): the most
    frequent (mv, dir) tuple of the inter 8x8 cells, the first in
    lexicographic order among equal counts, as the JAX package picks it
    with np.unique."""
    import types
    from x265_tpu.api.encoder import Encoder as JEncoder
    from x265_tpu_torch.api.encoder import Encoder as TEncoder
    rng = np.random.default_rng(len(case))
    h8, w8 = 17, 24
    span, scale = {"ties": (1, 1), "wide": (3, 40000), "single": (0, 1),
                   "no_inter": (2, 1)}[case]
    for _ in range(25):
        dec = types.SimpleNamespace(
            inter8=(rng.random((h8, w8)) < (0.0 if case == "no_inter"
                                             else 0.8)),
            mv8=(rng.integers(-span, span + 1, (h8, w8, 2, 2)) * scale)
            .astype(np.int32),
            dir8=rng.integers(1, 4, (h8, w8)).astype(np.int32))
        want, got = JEncoder._dominant_mv(dec), TEncoder._dominant_mv(dec)
        if want[0] is None:
            assert got == (None, None)
            continue
        assert np.array_equal(got[0], want[0]) and got[1] == want[1]
        assert got[0].dtype == np.int32
