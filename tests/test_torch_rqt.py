"""The explicit inter RQT level (tu-inter-depth 2) of
models/inter_residual.py against the JAX package: each 16x16 and 32x32
inter CU keeps its one TU or splits it into four, by a float32 RD cost.
Levels, recon, cbf and the split map are exact, with RDOQ off and on
(estBit constants, psy-RDOQ), lane by lane and through build_inter_pre.
The clips put a residual into one quadrant of many CUs, so the split
fires on a share of them and not on the rest; the split flips between
the two packages are counted and must be none."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax import enable_x64

from x265_tpu.engine.ctu_writer import FrameDecisions as JDec
from x265_tpu.hevc.rate_model import slice_rate_consts
from x265_tpu.models import inter_residual as jir
from x265_tpu_torch.models import inter_residual as tir
from x265_tpu_torch.utils.convert import (decisions_from_numpy,
                                          reference_from_numpy)
from torch_port_util import make_clip, slice_params

PAD = 80


def T(a):
    return torch.from_numpy(np.array(a))


def _quadrant_clip(w, h, seed, amp):
    """(source, reference): the source is the reference with noise of
    the given amplitude added to one random 8x8 (or 16x16) quadrant of
    every 16x16 (32x32) cell, and a faint noise everywhere."""
    ref = make_clip(w, h, 1, seed=seed)[0]
    rng = np.random.default_rng(seed)
    y = ref[0].astype(np.int32) + rng.integers(-1, 2, ref[0].shape)
    for cell in (32, 16):
        for by in range(0, h, 2 * cell):
            for bx in range(0, w, 2 * cell):
                q = int(rng.integers(0, 4))
                oy, ox = by + (q // 2) * (cell // 2), bx + (q % 2) * (cell // 2)
                y[oy:oy + cell // 2, ox:ox + cell // 2] += rng.integers(
                    -amp, amp + 1, (cell // 2, cell // 2))
    y = np.clip(y, 0, 255).astype(np.uint8)
    return (y, ref[1], ref[2]), ref


def _lanes(w, h, n, seed):
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h - n + 1:n, 0:w - n + 1:n]
    xy = np.stack([xs.ravel(), ys.ravel()], 1).astype(np.int32)
    N = len(xy)
    mv = np.zeros((N, 2, 2), np.int32)
    mv[:, 0] = rng.integers(-3, 4, (N, 2)) * (rng.random((N, 1)) < 0.3)
    return xy, mv, N


@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("rdoq,psy", [(False, 0), (True, 0), (True, 256)])
@pytest.mark.parametrize("qp", [22, 32])
def test_inter_class_body_rqt_exact(n, rdoq, psy, qp):
    w, h = 192, 128
    src, ref = _quadrant_clip(w, h, seed=n + qp, amp=24)
    xy, mv, N = _lanes(w, h, n, seed=qp)
    refp = [np.pad(np.asarray(pl).astype(np.int16),
                   PAD >> (0 if i == 0 else 1), mode="edge")[None]
            for i, pl in enumerate(ref)]
    dirm = np.ones(N, np.int32)
    ref_i = np.zeros(N, np.int32)
    qpv = np.full(N, qp, np.int32)
    kk = slice_rate_consts(1, qp)
    srcs = [np.asarray(p).astype(np.int32) for p in src]
    J = jnp.asarray
    with enable_x64():
        want = jir._inter_class_body(
            *(J(s) for s in srcs), *(J(r) for r in refp),
            *(J(r) for r in refp), J(xy), J(mv), J(dirm), J(ref_i), J(qpv),
            J(np.zeros((4, 3, 3), np.int32)), n, 8, True, rdoq, False, PAD,
            0, 0, 0, 0, False, J(kk) if rdoq else None, psy, True, J(kk))
    got = tir._inter_class_body(
        *(T(s).to(torch.int16) for s in srcs), *(T(r) for r in refp),
        None, None, None, T(xy), T(mv), T(dirm), T(ref_i), T(qpv), None,
        n, 8, True, rdoq, False, PAD, 0, 0, 0, 0, False,
        T(kk) if rdoq else None, psy, True, T(kk))
    names = ("lvl_y", "lvl_cb", "lvl_cr", "cbf", "rec_y", "rec_cb", "rec_cr",
             "tusplit")
    split_w = np.asarray(want[7])
    flips = int((got[7].numpy() != split_w).sum())
    assert flips == 0, f"{flips} of {N} split decisions differ"
    for g, w_, name in zip(got, want, names):
        assert np.array_equal(g.numpy(), np.asarray(w_)), name
    # the split fires on a share of the CUs, not on all of them
    assert 0 < split_w.sum() < N, split_w.sum()


@pytest.mark.parametrize("rdoq_level", [0, 2])
def test_build_inter_pre_rqt_exact(rdoq_level):
    """The whole frame (every size class, the split map tusplit8 that the
    writer and the deblock edge maps take) with tu-inter-depth 2."""
    w, h = 192, 128
    src, ref = _quadrant_clip(w, h, seed=5, amp=20)
    h8, w8 = h >> 3, w >> 3
    rng = np.random.default_rng(9)
    cu = np.full((h8, w8), 4, np.int32)
    cu[:4, :8] = 5                        # two 32x32 CUs
    cu[8:10, 20:24] = 3                   # some 8x8 CUs
    cu[12:16, 16:24] = 5
    mv = np.zeros((h8, w8, 2, 2), np.int32)
    mv[..., 0, :] = rng.integers(-2, 3, (h8, w8, 2))
    # motion is per CU: take each CU's top-left vector
    for y8 in range(h8):
        for x8 in range(w8):
            r = 1 << (cu[y8, x8] - 3)
            mv[y8, x8] = mv[y8 - y8 % r, x8 - x8 % r]
    maps = dict(cu_log2_map=cu, luma_mode8=np.zeros((h8, w8), np.int32),
                inter8=np.ones((h8, w8), bool),
                dir8=np.ones((h8, w8), np.int32), mv8=mv,
                ref8=np.zeros((h8, w8), np.int32))
    pj = slice_params("x265_tpu", w, h, ctu=32)
    pt = slice_params("x265_tpu_torch", w, h, ctu=32)
    for p in (pj, pt):
        p.tu_inter_depth = 2
        p.psy_rdoq = 1.0
    ref_pad = tuple(np.pad(np.asarray(pl).astype(np.int16),
                           PAD >> (0 if i == 0 else 1), mode="edge")
                    for i, pl in enumerate(ref))
    want = jir.build_inter_pre(
        src, JDec(**{k: np.array(v) for k, v in maps.items()}),
        ([ref_pad], []), 27, pj, None, True, rdoq_level)
    got = tir.build_inter_pre(
        src, decisions_from_numpy(**maps),
        ([reference_from_numpy(ref, device="cpu")], []), 27, pt, None,
        True, rdoq_level, device="cpu")
    for k in want:
        assert np.array_equal(got[k], np.asarray(want[k])), k
    tus = np.asarray(want["tusplit8"])
    assert tus.any() and not tus[cu == 4].all()
    assert not tus[cu == 3].any()         # 8x8 CUs never split here
