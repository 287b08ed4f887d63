"""models/inter_residual.py of the port against the JAX package:
build_inter_pre's dict, array by array, exact — on decisions that mix
every CU size class, intra CUs, sub-pel motion and picture-edge CUs."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from x265_tpu.engine.ctu_writer import FrameDecisions as JDec
from x265_tpu.models import inter_residual as jir
from x265_tpu_torch.models import inter_residual as tir
from x265_tpu_torch.utils.convert import (
    decisions_from_numpy, qp_map_from_numpy, reference_from_numpy,
    weights_from_numpy)
from torch_port_util import make_clip, slice_params


def _decisions(w, h, ctb_log2, seed):
    """Random but well-formed decision maps: CU sizes 8..2^ctb_log2
    aligned to their grid, ~85% inter, quarter-pel list-0 motion."""
    rng = np.random.default_rng(seed)
    h8, w8 = h >> 3, w >> 3
    cu = np.full((h8, w8), 3, np.int32)
    inter = np.zeros((h8, w8), bool)
    mv = np.zeros((h8, w8, 2, 2), np.int32)
    top = 1 << (ctb_log2 - 3)
    for by in range(0, h8, top):
        for bx in range(0, w8, top):
            lg = int(rng.integers(3, ctb_log2 + 1))
            r = 1 << (lg - 3)
            for y in range(by, min(by + top, h8), r):
                for x in range(bx, min(bx + top, w8), r):
                    if y + r > h8 or x + r > w8:
                        continue               # stays 8x8
                    cu[y:y + r, x:x + r] = lg
                    inter[y:y + r, x:x + r] = rng.random() < 0.85
                    mv[y:y + r, x:x + r, 0] = rng.integers(-70, 71, 2)
    maps = dict(cu_log2_map=cu,
                luma_mode8=rng.integers(0, 35, (h8, w8)).astype(np.int32),
                inter8=inter, dir8=np.ones((h8, w8), np.int32), mv8=mv,
                ref8=np.zeros((h8, w8), np.int32))
    return maps


@pytest.mark.parametrize("w,h,ctb,sdh,handles", [
    (192, 128, 5, True, False), (192, 128, 6, False, True),
    (200, 120, 5, True, True)])
def test_build_inter_pre_exact(w, h, ctb, sdh, handles):
    fr = make_clip(w, h, 2, seed=ctb)
    src, ref = fr[1], fr[0]
    maps = _decisions(w, h, ctb, seed=w + ctb)
    pj = slice_params("x265_tpu", w, h, ctu=1 << ctb)
    pt = slice_params("x265_tpu_torch", w, h, ctu=1 << ctb)
    pad = 80
    ref_pad = tuple(np.pad(np.asarray(pl).astype(np.int16),
                           pad >> (0 if i == 0 else 1), mode="edge")
                    for i, pl in enumerate(ref))
    want = jir.build_inter_pre(
        src, JDec(**{k: np.array(v) for k, v in maps.items()}),
        ([ref_pad], []), 30, pj, None, sdh, 0)
    ref_t = (reference_from_numpy(ref, device="cpu") if handles
             else ref_pad)
    got = tir.build_inter_pre(
        src, decisions_from_numpy(**maps), ([ref_t], []), 30, pt, None,
        sdh, 0, device="cpu")
    assert want is not None and set(got) == set(want)
    assert want["has8"].any() and want["cbf8"].any()
    for k in want:
        w_ = np.asarray(want[k])
        assert got[k].dtype == w_.dtype, k
        assert np.array_equal(got[k], w_), k


@pytest.mark.parametrize("wl,wc", [
    ((58, 7), ((64, -3), (64, 4))), ((70, -12), None), (None, ((64, 5),
                                                            (64, -6)))])
def test_build_inter_pre_weighted_qp_map_three_refs(wl, wc):
    """Explicit L0 weights on the nearest of three references, and a
    per-CTU QP map: the weighted uni-prediction branch and the per-CU QP
    reaching the transform chain and the chroma QP table."""
    w, h, ctb = 192, 128, 6
    fr = make_clip(w, h, 4, seed=7)
    src, refs = fr[3], [fr[2], fr[1], fr[0]]
    maps = _decisions(w, h, ctb, seed=11)
    rng = np.random.default_rng(5)
    maps["ref8"] = np.repeat(np.repeat(
        rng.integers(0, 3, (h >> 6, w >> 6)), 8, 0), 8, 1).astype(np.int32)
    maps["qp_map"] = qp_map_from_numpy(rng.integers(24, 37, (h >> 6, w >> 6)))
    pj = slice_params("x265_tpu", w, h, ctu=64, ref=3)
    pt = slice_params("x265_tpu_torch", w, h, ctu=64, ref=3)
    pad = 80
    ref_pads = [tuple(np.pad(np.asarray(pl).astype(np.int16),
                             pad >> (0 if i == 0 else 1), mode="edge")
                      for i, pl in enumerate(r)) for r in refs]
    wp = weights_from_numpy(wl, wc)
    want = jir.build_inter_pre(
        src, JDec(**{k: np.array(v) for k, v in maps.items()}),
        (ref_pads, []), 30, pj, wp, True, 0)
    refs_t = [reference_from_numpy(r, device="cpu") for r in refs]
    got = tir.build_inter_pre(src, decisions_from_numpy(**maps),
                              (refs_t, []), 30, pt, wp, True, 0, device="cpu")
    plain = tir.build_inter_pre(src, decisions_from_numpy(**maps),
                                (refs_t, []), 30, pt, None, True, 0,
                                device="cpu")
    for k in want:
        assert np.array_equal(got[k], np.asarray(want[k])), k
    # the weights changed the prediction
    key = "rec_y" if wl else "rec_cb"
    assert not np.array_equal(plain[key], got[key])


def test_inter_class_body_exact():
    """One size class, lane by lane, before the scatter."""
    w, h, n, N = 192, 128, 16, 50
    fr = make_clip(w, h, 2, seed=4)
    rng = np.random.default_rng(4)
    pad = 80
    refp = [np.pad(np.asarray(pl).astype(np.int16),
                   pad >> (0 if i == 0 else 1), mode="edge")[None]
            for i, pl in enumerate(fr[0])]
    xy = np.stack([rng.integers(0, (w - n) // 8, N) * 8,
                   rng.integers(0, (h - n) // 8, N) * 8], 1).astype(np.int32)
    mv = np.zeros((N, 2, 2), np.int32)
    mv[:, 0] = rng.integers(-90, 91, (N, 2))
    dirm = np.ones(N, np.int32)
    ref_i = np.zeros(N, np.int32)
    qp = rng.integers(20, 40, N).astype(np.int32)
    src = [np.asarray(p).astype(np.int32) for p in fr[1]]
    J = jnp.asarray
    want = jir._inter_class_body(
        *(J(s) for s in src), *(J(r) for r in refp), *(J(r) for r in refp),
        J(xy), J(mv), J(dirm), J(ref_i), J(qp), J(np.zeros((4, 3, 3),
                                                          np.int32)),
        n, 8, True, False, False, pad, 0, 0, 0, 0)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))   # noqa: E731
    got = tir._inter_class_body(
        *(T(s).to(torch.int16) for s in src), *(T(r) for r in refp),
        None, None, None, T(xy), T(mv), T(dirm), T(ref_i), T(qp), None,
        n, 8, True, False, False, pad, 0, 0, 0, 0)
    for g, w_ in zip(got, want):
        w_ = np.asarray(w_)
        assert np.array_equal(g.numpy(), w_)
        assert str(g.dtype).replace("torch.", "") == str(w_.dtype)


def test_unported_inputs_raise():
    """No input is refused any more: scaling lists (the last one, now
    held at 10 bits by tests/test_torch_main10.py) give the JAX package's
    arrays; RDOQ and the explicit RQT level are ported
    (tests/test_torch_rqt.py); a picture with no inter CU gives None."""
    w, h = 64, 64
    fr = make_clip(w, h, 2, seed=1)
    maps = _decisions(w, h, 5, 0)
    maps["inter8"][:] = True
    pt = slice_params("x265_tpu_torch", w, h)
    ref_pad = tuple(np.pad(np.asarray(pl).astype(np.int16),
                           80 >> (0 if i == 0 else 1), mode="edge")
                    for i, pl in enumerate(fr[0]))
    dec = decisions_from_numpy(**maps)
    pt.scaling_lists = "default"
    pj = slice_params("x265_tpu", w, h)
    pj.scaling_lists = "default"
    got = tir.build_inter_pre(fr[1], dec, ([ref_pad], []), 30, pt, None,
                              True, 1, device="cpu")
    want = jir.build_inter_pre(
        fr[1], JDec(**{k: np.array(v) for k, v in maps.items()}),
        ([ref_pad], []), 30, pj, None, True, 1)
    for k in want:
        assert np.array_equal(got[k], np.asarray(want[k])), k
    pt.scaling_lists = ""
    pt.tu_inter_depth = 2
    got = tir.build_inter_pre(fr[1], dec, ([ref_pad], []), 30, pt, None,
                              True, 2, device="cpu")        # rdoq + rqt
    assert got is not None and got["has8"].all()
    dec.inter8[:] = False
    assert tir.build_inter_pre(fr[1], dec, ([ref_pad], []), 30, pt, None,
                               True, 0, device="cpu") is None
