"""The device modules of the port at 10 bits (Main10) against the JAX
package on the same numpy inputs: clips from utils/testclip lifted by
testclip.lift10 (uint16, samples up to 1023), and a dark picture whose
samples all lie below 256, as PQ content often has.

- models/intra_frame: the single-frame analysis (its depth from the
  array's dtype) and the batch analysis (a uint8 wire only while every
  sample is below 256): modes exact, fp32 costs to 1e-4 relative (as at
  8 bits; 5.8e-7 measured);
- engine/me: _phase_planes clamped at 1023; motion_fused with the
  hierarchical search and its window entry, with the dense search at
  R=57 (subme 3), and with bi-prediction (_bi_satd): vectors and SATDs
  exact, costs as in tests/test_torch_me.py;
- engine/lookahead: per-frame costs and block records, and the pair
  costs on 10-bit lowres planes: exact;
- engine/aq: modes 1-3 with the depth correction and hdr10_opt's
  luma-banded bias: equal to the last bit;
- engine/weightp: the 10-bit weight fit and the weighted search plane;
- models/loopfilter + hevc/sao: the deblock with beta and tC scaled to
  the depth, the SAO statistics, decision (band shift bd - 5) and apply;
- models/inter_residual.build_inter_pre with scaling lists, RDOQ and the
  explicit RQT at QPs up to 51 (Qp' up to 63): every array exact, the
  recon planes int16;
- models/rdo and models/intra_rdo with scaling lists: decisions exact,
  costs within tests/test_torch_rdo.py's COST_RTOL.
"""
import copy

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax import enable_x64

from x265_tpu.api import params as JP
from x265_tpu.engine import aq as jaq
from x265_tpu.engine import lookahead as jla
from x265_tpu.engine import me as jme
from x265_tpu.engine import weightp as jwp
from x265_tpu.engine import planes as jplanes
from x265_tpu.engine.ctu_writer import FrameDecisions as JDec
from x265_tpu.engine.me import dominant_tuples
from x265_tpu.hevc import sao as jsao
from x265_tpu.models import inter_residual as jir
from x265_tpu.models import intra_frame as jif
from x265_tpu.models import intra_rdo as jirdo
from x265_tpu.models import loopfilter as jlf
from x265_tpu.models import rdo as jrdo
from x265_tpu_torch.api import params as TP
from x265_tpu_torch.engine import aq as taq
from x265_tpu_torch.engine import lookahead as tla
from x265_tpu_torch.engine import me as tme
from x265_tpu_torch.engine import weightp as twp
from x265_tpu_torch.engine.planes import FramePlanes
from x265_tpu_torch.hevc import sao as tsao
from x265_tpu_torch.models import inter_residual as tir
from x265_tpu_torch.models import intra_frame as tif
from x265_tpu_torch.models import intra_rdo as tirdo
from x265_tpu_torch.models import loopfilter as tlf
from x265_tpu_torch.models import rdo as trdo
from x265_tpu_torch.utils import convert
from x265_tpu_torch.utils.testclip import (lift10, make_clip,
                                            make_cut_clip, make_ramp_clip)
from test_torch_inter_residual import _decisions
from test_torch_loopfilter import _state
from test_torch_rdo import COST_RTOL, _motion, _promo_inputs

W, H, PAD = 192, 128, 80


def clip10(n, seed, maker=make_clip, w=W, h=H):
    return lift10(maker(w, h, n, seed), seed)


def dark(frames):
    """The same pictures at a quarter of their level: uint16 samples all
    below 256."""
    return [tuple((pl >> 2).astype(np.uint16) for pl in f) for f in frames]


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("level", ["bright", "dark"])
def test_intra_analysis_10bit(level):
    fr = clip10(3, 1)
    if level == "dark":
        fr = dark(fr)
        assert max(int(f[0].max()) for f in fr) < 256
    else:
        assert max(int(f[0].max()) for f in fr) > 255
    y = fr[0][0]
    assert y.dtype == np.uint16
    dj, ij = jif.decide_intra_frame_tpu_with_cost(y, W, H, cu_log2=4,
                                                  fast=False, psy=2.0)
    dt, it = tif.decide_intra_frame_tpu_with_cost(y, W, H, cu_log2=4,
                                                  fast=False, psy=2.0,
                                                  device="cpu")
    assert np.array_equal(dt.luma_mode8, dj.luma_mode8)
    assert np.array_equal(dt.cu_log2_map, dj.cu_log2_map)
    # fp32 costs: 10-bit SATDs reach 1e5, where the bank's sums round
    # in another order (5.8e-7 relative at most on this picture; the
    # stated tolerance of tests/test_torch_intra.py), modes exact
    np.testing.assert_allclose(it, ij, rtol=1e-4)
    ys = [f[0] for f in fr]
    want = jif.submit_intra_analysis_batch(ys, W, H, 4, fast=True, psy=0.0)
    got = tif.submit_intra_analysis_batch(ys, W, H, 4, fast=True, psy=0.0,
                                          device="cpu")
    for g, w in zip(got, want):
        assert np.array_equal(g[0].numpy(), np.asarray(w[0]))
        np.testing.assert_allclose(g[1].numpy(), np.asarray(w[1]),
                                   rtol=1e-4)


def test_phase_planes_1023():
    ref = clip10(1, 2)[0][0].astype(np.int32)
    ref[:8, :8] = 1023                         # the clamp is reached
    rp = np.pad(ref, ((5, 6), (5, 6)), mode="edge")
    want = np.asarray(jme._phase_planes(jnp.asarray(rp), 1023))
    got = tme._phase_planes(torch.from_numpy(rp), 1023)
    assert got.dtype == torch.int16 and np.array_equal(got.numpy(), want)
    assert want.max() == 1023 and want.max() > 255


@pytest.mark.parametrize("search", ["hme", "dense", "bi"])
def test_motion_fused_10bit(search):
    fr = clip10(5, 3)
    if search == "bi":
        cur = fr[2][0]
        refs = [fr[0][0], fr[4][0]]
        kw = dict(R=57, subme=2, do_bi=True)
    else:
        cur = fr[4][0]
        refs = [f[0].astype(np.int32) for f in fr[3::-1]]
        kw = (dict(R=57, subme=2) if search == "hme"
              else dict(R=57, subme=3, force_dense=True))
    calls = []
    local = tme._local_search

    def local_rec(*a, **k):
        calls.append(1)
        return local(*a, **k)
    tme._local_search = local_rec
    try:
        got = tme.motion_fused(cur, refs, W, H, qp=30, bit_depth=10,
                               slack=48.0, device="cpu", **kw)
    finally:
        tme._local_search = local
    want = jme.motion_fused(cur, refs, W, H, qp=30, bit_depth=10,
                            slack=48.0, **kw)
    mt, ct, st, bt = got
    mj, cj, sj, bj = want
    assert np.any(mj != 0)
    assert np.array_equal(mt, mj) and np.array_equal(st, sj)
    np.testing.assert_allclose(ct, cj, rtol=1e-4)
    if search == "bi":
        assert np.array_equal(np.asarray(bt), np.asarray(bj))
    assert bool(calls) == (search != "dense")


def test_lookahead_and_pair_costs_10bit():
    w, h = 160, 104
    frames = lift10(make_cut_clip(w, h, 5, seed=4, cut=3), 4)
    jl = jla.Lookahead(w, h, 10)
    tl = tla.Lookahead(w, h, 10, device="cpu")
    lows = []
    for i, (y, _cb, _cr) in enumerate(frames):
        assert tl.frame_costs(y, i == 0) == jl.frame_costs(y, i == 0)
        for k in ("icost", "mcost", "mv"):
            assert np.array_equal(tl.last_blocks[k], jl.last_blocks[k])
        low = tl.last_low.numpy()
        assert np.array_equal(low, np.asarray(jl.last_low))
        lows.append(low)
    assert max(int(lw.max()) for lw in lows) > 255
    pairs = [(lows[i], lows[j]) for i in range(4) for j in range(4)
             if i != j]
    want = jla.batched_pair_costs(pairs)
    got = tla.batched_pair_costs(pairs, device="cpu")
    for g, wnt in zip(got, want):
        assert np.array_equal(g, np.asarray(wnt))


@pytest.mark.parametrize("mode", [1, 2, 3])
@pytest.mark.parametrize("hdr10_opt", [False, True])
def test_aq_10bit_hdr10_opt(mode, hdr10_opt):
    y, cb, cr = clip10(1, 5 + mode)[0]
    want = jaq.aq_qp_offsets(y, 6, mode, 1.0, cb=cb, cr=cr, bit_depth=10,
                             hdr10_opt=hdr10_opt)
    got = taq.aq_qp_offsets(y, 6, mode, 1.0, cb=cb, cr=cr, bit_depth=10,
                            hdr10_opt=hdr10_opt, device="cpu")
    assert got.dtype == np.float64 and np.array_equal(got, want)
    assert np.any(np.rint(got) != 0)


def test_weightp_10bit():
    frames = clip10(4, 6, make_ramp_clip)
    found = 0
    for cur, ref in zip(frames[1:], frames[:-1]):
        want = jwp.analyze_slice_weights(cur, ref, 10)
        assert twp.analyze_slice_weights(cur, ref, 10) == want
        fp = convert.reference_from_numpy(ref, 10, "cpu")
        assert twp.analyze_slice_weights(cur, fp, 10) == want
        found += want[0] is not None
    assert found >= 2
    ref = frames[0]
    for wgt, off in ((70, -36), (58, 48), (127, -512)):
        jref = jplanes.FramePlanes(host=tuple(np.asarray(p) for p in ref),
                                   bd=10)
        a = np.asarray(jwp.weight_luma_me_handle(jref, wgt, off, 10)
                       .dev_luma_me(20, H, W))
        tref = convert.reference_from_numpy(ref, 10, "cpu")
        b = twp.weight_luma_me_handle(tref, wgt, off, 10).dev_luma_me(
            20, H, W)
        assert np.array_equal(a, b.numpy())
        assert np.array_equal(
            twp.weight_plane(np.asarray(ref[0]), wgt, off, 10),
            jwp.weight_plane(np.asarray(ref[0]), wgt, off, 10))


@pytest.mark.parametrize("h,w,ctb_log2", [(64, 128, 6), (120, 200, 5)])
def test_deblock_sao_10bit(h, w, ctb_log2):
    rng = np.random.default_rng(40 + h)
    base = rng.integers(240, 800, (h // 8 + 2, w // 8 + 2))
    y = np.kron(base, np.ones((8, 8), np.int64))[:h, :w]
    y = np.clip(y + rng.integers(-24, 25, (h, w)), 0, 1023).astype(np.int32)
    cb = np.clip(y[::2, ::2] // 2 + 240, 0, 1023).astype(np.int32)
    cr = np.clip(1000 - y[::2, ::2] // 2, 0, 1023).astype(np.int32)
    src = tuple(np.clip(p + rng.integers(-12, 13, p.shape), 0, 1023)
                .astype(np.uint16) for p in (y, cb, cr))
    st, is_intra4, mv4, refpoc4 = _state(rng, h, w, True)
    args = (st, is_intra4, mv4, refpoc4, 30, 1, -1, 1, -1, 10)
    want = jlf.deblock_frame_device((y, cb, cr), *args, sao_src=src,
                                    ctb_log2=ctb_log2)
    got = tlf.deblock_frame_device((y, cb, cr), *args, sao_src=src,
                                   ctb_log2=ctb_log2, device="cpu")
    for j, t in zip(want[:3], got[:3]):
        assert np.array_equal(np.asarray(j, np.int32), t)
    assert (got[0] != y).any()
    for pl in range(3):
        for k in range(4):
            assert np.array_equal(np.asarray(want[3][pl][k]), got[3][pl][k])
    sp_j = jsao.analyze_frame(src, got[:3], ctb_log2, 30, 10, stats=want[3])
    sp_t = tsao.analyze_frame(src, got[:3], ctb_log2, 30, 10, stats=got[3])
    for k, v in convert.sao_params_to_numpy(sp_t).items():
        assert np.array_equal(v, getattr(sp_j, k)), k
    assert (sp_t.type_y == 1).any() or (sp_t.type_c == 1).any()  # band
    rec = tuple(np.asarray(p).astype(np.int16) for p in got[:3])
    aj = jlf.sao_apply_device(tuple(jnp.asarray(p) for p in rec),
                              jsao.SaoParams(
                                  **convert.sao_params_to_numpy(sp_t)),
                              ctb_log2, 10)
    at = tlf.sao_apply_device(tuple(torch.from_numpy(p) for p in rec),
                              sp_t, ctb_log2, 10)
    for j, t in zip(aj, at):
        assert np.array_equal(np.asarray(j, np.int32),
                              t.numpy().astype(np.int32))


def _params10(pkg, w, h, **opts):
    p = pkg.param_default_preset("slow")
    for k, v in {"output-depth": "10", "scaling-list": "default",
                 **opts}.items():
        pkg.param_parse(p, k, v)
    p.width, p.height = w, h
    return p


@pytest.mark.parametrize("rdoq,rqt", [(0, False), (2, True)])
def test_build_inter_pre_10bit_scaling(rdoq, rqt):
    w, h, ctb = 192, 128, 6
    fr = clip10(2, 7 + rdoq)
    src, ref = fr[1], fr[0]
    maps = _decisions(w, h, ctb, seed=3 + rdoq)
    rng = np.random.default_rng(rdoq)
    maps["qp_map"] = convert.qp_map_from_numpy(
        rng.integers(20, 52, (h >> 6, w >> 6)))
    opts = {"ctu": "64", "tu-inter-depth": "2" if rqt else "1"}
    pj, pt = _params10(JP, w, h, **opts), _params10(TP, w, h, **opts)
    ref_pad = tuple(np.pad(np.asarray(pl).astype(np.int16),
                           PAD >> (0 if i == 0 else 1), mode="edge")
                    for i, pl in enumerate(ref))
    want = jir.build_inter_pre(
        src, JDec(**{k: np.array(v) for k, v in maps.items()}),
        ([ref_pad], []), 34, pj, None, True, rdoq)
    got = tir.build_inter_pre(src, convert.decisions_from_numpy(**maps),
                              ([convert.reference_from_numpy(ref, 10, "cpu")],
                               []), 34, pt, None, True, rdoq, device="cpu")
    assert set(got) == set(want)
    for k in want:
        wk = np.asarray(want[k])
        assert got[k].dtype == wk.dtype and np.array_equal(got[k], wk), k
    assert got["rec_y"].dtype == np.int16 and got["rec_y"].max() > 255
    assert want["cbf8"].any()
    if rqt:
        assert want["tusplit8"].any()


def _scene10(seed):
    frames = clip10(3, seed)
    cur, refs = frames[2], [frames[1], frames[0]]
    jrefs = [tuple(np.pad(np.asarray(pl).astype(np.int16),
                          PAD >> (0 if i == 0 else 1), mode="edge")
                   for i, pl in enumerate(r)) for r in refs]
    trefs = [FramePlanes(host=tuple(np.asarray(pl, np.int32) for pl in r),
                         bd=10, device="cpu") for r in refs]
    return cur, jrefs, trefs


def _rd_params(pkg, qp):
    p = _params10(pkg, W, H)
    pkg.param_parse(p, "qp", str(qp))
    return p


@pytest.mark.parametrize("qp", [22, 37])
def test_rd_adopt16_and_promote_10bit_scaling(qp):
    cur, jrefs, trefs = _scene10(qp)
    nby, nbx = H // 16, W // 16
    dir_blk, mv_blk, ref_blk, inter = _motion(qp, nby, nbx)
    cands = dominant_tuples(dir_blk, mv_blk, ref_blk, inter)
    with enable_x64():
        want = jrdo.rd_adopt16(cur, jrefs, [], inter, mv_blk, dir_blk,
                               ref_blk, cands, qp, _rd_params(JP, qp))
    got = trdo.rd_adopt16(cur, trefs, [], inter, mv_blk, dir_blk, ref_blk,
                          cands, qp, _rd_params(TP, qp), device="cpu")
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))
    assert 0 < want[3].sum()
    for n in (32, 64):
        cand, mv4, dirm, ref_i = _promo_inputs(qp + n, n)
        with enable_x64():
            jp, jmv = jrdo.rd_promote(cur, jrefs, [], cand, mv4, dirm,
                                      ref_i, qp, _rd_params(JP, qp), n=n)
        tp, tmv = trdo.rd_promote(cur, trefs, [], cand, mv4, dirm, ref_i,
                                  qp, _rd_params(TP, qp), n=n,
                                  device="cpu")
        assert np.array_equal(tp, np.asarray(jp))
        assert np.array_equal(tmv, jmv)


def test_promo_costs_10bit_scaling():
    n, qp = 32, 30
    cur, jrefs, _ = _scene10(5)
    cand, mv4, dirm, ref_i = _promo_inputs(5, n)
    G = len(cand)
    xy = np.stack([cand[:, 1] * n, cand[:, 0] * n], 1).astype(np.int32)
    oh1 = np.full(G, 6, np.float32)
    oh4 = np.full(G, 34, np.float32)
    from x265_tpu.hevc import rate_model as jrm
    rk = jrm.rdoq_rate_consts(2, qp)
    kw = dict(n=n, bd=10, sdh=True, do_rdoq=True, scaling=True, pad=PAD,
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


@pytest.mark.parametrize("qp", [22, 37])
def test_rd_intra_promote32_10bit_scaling(qp):
    cur = clip10(1, qp)[0]
    y = cur[0].copy()
    y[:64, :64] = 480
    y[64:, 128:] = (4 * (np.arange(64)[:, None] + np.arange(64)[None, :])
                    ).astype(np.uint16)
    cur = (y, cur[1], cur[2])
    dec = jif.decide_intra_frame_tpu(y, W, H, cu_log2=4, fast=False,
                                     psy=2.0)
    jdec, tdec = copy.deepcopy(dec), copy.deepcopy(dec)
    n_j = jirdo.rd_intra_promote32(cur, jdec, qp, _rd_params(JP, qp))
    n_t = tirdo.rd_intra_promote32(cur, tdec, qp, _rd_params(TP, qp),
                                   device="cpu")
    assert n_t == n_j and n_j > 0
    for k in ("cu_log2_map", "luma_mode8", "chroma_mode8"):
        assert np.array_equal(getattr(tdec, k), getattr(jdec, k))
