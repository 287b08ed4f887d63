"""The B-frame modules of the port against the JAX package on the same
numpy inputs (192x128 and smaller):

- engine/me.py: _bi_satd, the bi-prediction search of motion_fused
  (do_bi), mv_field_median3 and motion_fused_frames for 2 and 3 frames
  against the reference's vmapped version — mvs, SATDs and the bi SATD
  exact, the float32 costs exact too;
- models/intra_frame.submit_intra_analysis_batch — modes exact, costs
  exact (the prediction bank's weights are dyadic);
- models/inter_residual.build_inter_pre with list-1 and bi lanes, with and
  without an explicit L0 weight — every array exact;
- engine/lookahead: batched_pair_costs exact (int32 block maps) and
  slicetype_split's index equal on a pan, a static clip and a cut.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from x265_tpu.engine import lookahead as jla
from x265_tpu.engine import me as jme
from x265_tpu.engine.ctu_writer import FrameDecisions as JDec
from x265_tpu.models import inter_residual as jir
from x265_tpu.models import intra_frame as jif
from x265_tpu_torch.engine import lookahead as tla
from x265_tpu_torch.engine import me as tme
from x265_tpu_torch.models import inter_residual as tir
from x265_tpu_torch.models import intra_frame as tif
from x265_tpu_torch.utils.convert import decisions_from_numpy
from torch_port_util import make_clip, slice_params

W, H = 192, 128


def _triplet(seed, step=(2, 3)):
    """(previous anchor, current picture, next anchor) luma planes of a
    moving clip: the current picture sits half way between."""
    fr = make_clip(W, H, 5, seed, step)
    return fr[0][0], fr[2][0], fr[4][0]


def test_mv_field_median3():
    rng = np.random.default_rng(0)
    mv = rng.integers(-40, 41, (8, 12, 2)).astype(np.int32)
    got = tme.mv_field_median3(mv)
    want = jme.mv_field_median3(mv)
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)


def test_bi_satd():
    """The average of two phase-plane gathers, then SATD: per block, at
    random quarter-pel vectors on both references."""
    r0, cur, r1 = _triplet(4)
    S, margin, R = 16, 18, 16
    nby, nbx = H // S, W // S
    N = nby * nbx
    rng = np.random.default_rng(4)
    mv0 = rng.integers(-60, 61, (N, 2)).astype(np.int32)
    mv1 = rng.integers(-60, 61, (N, 2)).astype(np.int32)
    bx, by = np.meshgrid(np.arange(nbx), np.arange(nby))
    bxy = np.stack([bx.reshape(-1), by.reshape(-1)], 1).astype(np.int32)
    blocks = (cur.astype(np.int32).reshape(nby, S, nbx, S)
              .transpose(0, 2, 1, 3).reshape(N, S, S))

    def planes(ref):
        pad = np.pad(ref.astype(np.int32), margin + 4, mode="edge")
        return pad[1:, 1:]             # (margin+3) before, (margin+4) after

    pj = [jme._phase_planes(jnp.asarray(planes(r)), 255) for r in (r0, r1)]
    pt = [tme._phase_planes(torch.from_numpy(planes(r)), 255)
          for r in (r0, r1)]
    assert R + 2 == margin
    want = np.asarray(jme._bi_satd(jnp.asarray(blocks), pj[0], pj[1],
                                   jnp.asarray(mv0), jnp.asarray(mv1),
                                   jnp.asarray(bxy), S, margin))
    got = tme._bi_satd(torch.from_numpy(blocks), pt[0], pt[1],
                       torch.from_numpy(mv0), torch.from_numpy(mv1),
                       torch.from_numpy(bxy), S, margin).numpy()
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)
    assert want.min() > 0


@pytest.mark.parametrize("R,subme", [(57, 2), (16, 1)])
def test_motion_fused_bi(R, subme):
    r0, cur, r1 = _triplet(R + subme)
    kw = dict(R=R, qp=32, subme=subme, do_bi=True, slack=24.0)
    want = jme.motion_fused(cur, [r0.astype(np.int32), r1.astype(np.int32)],
                            W, H, **kw)
    got = tme.motion_fused(cur, [r0.astype(np.int32), r1.astype(np.int32)],
                           W, H, device="cpu", **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    mv, bi = want[0], want[3]
    assert np.any(mv[0] != 0) and np.any(mv[1] != 0)
    # the two anchors lie on either side: the vectors point opposite ways
    assert np.median(mv[1][..., 0]) < 0 < np.median(mv[0][..., 0])
    assert bi.max() > 0


@pytest.mark.parametrize("K", [2, 3])
def test_motion_fused_frames(K):
    """The leaf-B batch: K pictures against the same anchor pair, each
    at its own float32 lambda (the reference vmaps one graph over them)."""
    fr = make_clip(W, H, K + 2, seed=K)
    r0, r1 = fr[0][0], fr[K + 1][0]
    curs = [f[0] for f in fr[1:K + 1]]
    qps = [30 + 2 * k for k in range(K)]
    kw = dict(R=57, qps=qps, subme=2, do_bi=True, slack=48.0)
    want = jme.motion_fused_frames(curs, [r0, r1], W, H, **kw)
    got = tme.motion_fused_frames(curs, [r0, r1], W, H, device="cpu", **kw)
    assert len(got) == len(want) == K
    for gk, wk in zip(got, want):
        for g, w in zip(gk, wk):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def test_submit_intra_analysis_batch():
    fr = make_clip(200, 120, 3, seed=1)
    ys = [f[0] for f in fr]
    for fast, psy in ((False, 2.0), (True, 0.0)):
        want = jif.submit_intra_analysis_batch(ys, 200, 120, 4, fast=fast,
                                               psy=psy)
        got = tif.submit_intra_analysis_batch(ys, 200, 120, 4, fast=fast,
                                              psy=psy, device="cpu")
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert np.array_equal(g[0].numpy(), np.asarray(w[0]))
            assert np.array_equal(g[1].numpy(), np.asarray(w[1]))
            dg = tif.finish_intra_analysis(g)
            dw = jif.finish_intra_analysis(w)
            assert np.array_equal(dg.luma_mode8, dw.luma_mode8)
            assert np.array_equal(dg.cu_log2_map, dw.cu_log2_map)


def _b_decisions(w, h, ctb_log2, seed):
    """Random well-formed B decision maps: CU sizes aligned to their grid,
    ~85% inter, each inter CU L0, L1 or bi with its own quarter-pel
    vectors (ref 0 of each list)."""
    rng = np.random.default_rng(seed)
    h8, w8 = h >> 3, w >> 3
    cu = np.full((h8, w8), 3, np.int32)
    inter = np.zeros((h8, w8), bool)
    dirm = np.ones((h8, w8), np.int32)
    mv = np.zeros((h8, w8, 2, 2), np.int32)
    top = 1 << (ctb_log2 - 3)
    for by in range(0, h8, top):
        for bx in range(0, w8, top):
            lg = int(rng.integers(3, ctb_log2 + 1))
            r = 1 << (lg - 3)
            for y in range(by, min(by + top, h8), r):
                for x in range(bx, min(bx + top, w8), r):
                    if y + r > h8 or x + r > w8:
                        continue
                    cu[y:y + r, x:x + r] = lg
                    inter[y:y + r, x:x + r] = rng.random() < 0.85
                    d = int(rng.integers(1, 4))
                    dirm[y:y + r, x:x + r] = d
                    if d & 1:
                        mv[y:y + r, x:x + r, 0] = rng.integers(-70, 71, 2)
                    if d & 2:
                        mv[y:y + r, x:x + r, 1] = rng.integers(-70, 71, 2)
    return dict(cu_log2_map=cu,
                luma_mode8=rng.integers(0, 35, (h8, w8)).astype(np.int32),
                inter8=inter, dir8=dirm, mv8=mv,
                ref8=np.zeros((h8, w8), np.int32))


def _pad(planes):
    return tuple(np.pad(np.asarray(pl).astype(np.int16),
                        80 >> (0 if i == 0 else 1), mode="edge")
                 for i, pl in enumerate(planes))


@pytest.mark.parametrize("w,h,ctb,weighted", [
    (192, 128, 6, False), (192, 128, 5, True), (200, 120, 5, False)])
def test_build_inter_pre_bi(w, h, ctb, weighted):
    """L0, L1 and bi lanes in every CU size class; with an explicit L0
    weight, only the L0 uni lanes take it."""
    fr = make_clip(w, h, 3, seed=ctb + w)
    src, ref0, ref1 = fr[1], fr[0], fr[2]
    maps = _b_decisions(w, h, ctb, seed=w + ctb)
    dirs = maps["dir8"][maps["inter8"]]
    assert {1, 2, 3} <= set(np.unique(dirs).tolist())
    pj = slice_params("x265_tpu", w, h, ctu=1 << ctb)
    pt = slice_params("x265_tpu_torch", w, h, ctu=1 << ctb)
    wp = None
    if weighted:
        arr = np.zeros((4, 3, 3), np.int32)
        arr[0] = [(1, 50, -3), (1, 60, 2), (1, 70, -5)]
        wp = (arr, 6, 6)
    refs = ([_pad(ref0)], [_pad(ref1)])
    want = jir.build_inter_pre(
        src, JDec(**{k: np.array(v) for k, v in maps.items()}), refs, 30,
        pj, wp, True, 0, slice_type=0)
    got = tir.build_inter_pre(src, decisions_from_numpy(**maps), refs, 30,
                              pt, wp, True, 0, slice_type=0, device="cpu")
    assert set(got) == set(want)
    for k in want:
        if want[k] is None:
            assert got[k] is None, k
            continue
        w_ = np.asarray(want[k])
        assert np.array_equal(got[k], w_), k
        assert got[k].dtype == w_.dtype, k
    assert want["has8"].sum() > 0


def _lows(mode, n=6, h=32, w=48, seed=1):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 255, (h, w)).astype(np.int32)
    b = rng.integers(0, 255, (h, w)).astype(np.int32)

    def noisy(x):
        return np.clip(x + rng.integers(-3, 3, x.shape), 0, 255)
    if mode == "pan":
        return [noisy(np.roll(a, 3 * i, 1)) for i in range(n)]
    if mode == "static":
        return [noisy(a) for _ in range(n)]
    return [noisy(a), noisy(b), noisy(b), noisy(b), noisy(b)][:n]


def test_batched_pair_costs():
    lows = _lows("pan")
    pairs = [(lows[i], lows[j]) for i in range(4) for j in range(4)
             if i != j]
    want = jla.batched_pair_costs(pairs)
    got = tla.batched_pair_costs(pairs, device="cpu")
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype == np.int32 and np.array_equal(g, w)
    # a second call is served from the memo: the very same arrays
    again = tla.batched_pair_costs(pairs[:3], device="cpu")
    assert all(a is b for a, b in zip(again, got[:3]))


@pytest.mark.parametrize("mode,max_bs,disc", [
    ("pan", 4, 0.9), ("static", 4, 0.9), ("static", 3, 0.81),
    ("cut", 4, 0.9)])
def test_slicetype_split(mode, max_bs, disc):
    lows = _lows(mode)
    anchor, queue = lows[0], lows[1:]
    want = jla.slicetype_split(anchor, queue, max_bs=max_bs,
                               b_discount=disc)
    got = tla.slicetype_split(anchor, queue, max_bs=max_bs, b_discount=disc,
                              device="cpu")
    assert got == want
    if mode == "cut":
        assert got <= 1                  # anchors before the cut
    if mode == "static":
        assert got >= 1                  # keeps B frames on a still scene
