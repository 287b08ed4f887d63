"""B decisions of the port against the JAX package on the same inputs
(192x128): Encoder._b_select at rd 2 (SATD merge adoption with a list-1
reference, host promotion rules) and rd 3 (rd_adopt16 and the 32/64
promotions with both lists), fed the same intra analysis and the same
bi-prediction search results; and the RD costs of models/rdo.py with a
non-empty list-1 stack and L1 and bi lanes.

Tolerance: decisions exact — the test counts every decision map entry
that differs (flips) and requires 0. RD costs within 4e-7 relative (the
reference's float32 sum order of TB rates above 512 bits; see
tests/test_torch_rdo.py); the argmin over them is exact."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax import enable_x64

from x265_tpu.api import params as JP
from x265_tpu.api.encoder import Encoder as JEncoder
from x265_tpu.engine import me as jme
from x265_tpu.hevc import rate_model as jrm
from x265_tpu.models import rdo as jrdo
from x265_tpu_torch.api import params as TP
from x265_tpu_torch.api.encoder import Encoder as TEncoder
from x265_tpu_torch.models import rdo as trdo
from x265_tpu_torch.utils.convert import decisions_from_numpy
from torch_port_util import make_hard_clip

W, H, PAD = 192, 128, 80
COST_RTOL = 4e-7
FIELDS = ("cu_log2_map", "luma_mode8", "chroma_mode8", "inter8", "dir8",
          "mv8", "ref8")


def T(a):
    return torch.from_numpy(np.array(a))


def _params(pkg, preset, qp):
    p = pkg.param_default_preset(preset)
    pkg.param_parse(p, "qp", str(qp))
    p.width, p.height = W, H
    return p


def _me_inputs(jenc, frames, qp):
    """The JAX package's intra analysis and bi-prediction search of the
    middle picture between its two neighbours."""
    p = jenc.param
    (f0, cur, f1) = frames
    dec, icost = jenc._intra_analysis_with_cost(cur[0])
    mv, cost, satd, bi = jme.motion_fused(
        cur[0], [f0[0], f1[0]], W, H, S=16, R=p.me_range, qp=qp,
        subme=max(1, p.sub_me), do_bi=True,
        slack=48.0 if p.early_skip else 24.0)
    return dec, icost, mv, cost, satd, bi


@pytest.mark.parametrize("preset,qp", [("fast", 30), ("medium", 30),
                                       ("medium", 24)])
def test_b_select_decisions_exact(preset, qp):
    frames = make_hard_clip(W, H, 3, seed=qp)
    jenc = JEncoder(_params(JP, preset, qp))
    tenc = TEncoder(_params(TP, preset, qp), device="cpu")
    assert jenc.param.rd_level == tenc.param.rd_level == (
        3 if preset == "medium" else 2)
    dec, icost, mv, cost, satd, bi = _me_inputs(jenc, frames, qp)
    lam = float(np.sqrt(0.85 * 2.0 ** ((qp - 12) / 3.0)))
    maps = {k: getattr(dec, k) for k in FIELDS if getattr(dec, k) is not None}
    tdec = decisions_from_numpy(**maps)
    (f0, cur, f1) = frames
    want = jenc._b_select(dec, icost, mv, cost, bi, lam, satd=satd,
                          y=cur[0], refs=(f0[0], f1[0]), qp=qp, frame=cur,
                          ref_tuples=(f0, f1))
    got = tenc._b_select(tdec, icost.copy(), mv, cost, bi, lam,
                         satd=satd, y=cur[0], refs=(f0[0], f1[0]), qp=qp,
                         frame=cur, ref_tuples=(f0, f1))
    flips = 0
    for k in FIELDS:
        w_, g_ = getattr(want, k), getattr(got, k)
        if w_ is None:
            assert g_ is None, k
            continue
        assert np.shape(g_) == np.shape(w_), k
        flips += int((np.asarray(g_) != np.asarray(w_)).sum())
    assert flips == 0
    dirs = set(np.unique(want.dir8[want.inter8.astype(bool)]).tolist())
    assert len(dirs) >= 2, dirs                   # L0/L1/bi all compete
    assert (want.cu_log2_map > 4).any()           # promotions fired


def _l1_scene(seed):
    frames = make_hard_clip(W, H, 3, seed=seed)
    f0, cur, f1 = frames

    def pad(fr):
        return [np.pad(np.asarray(pl).astype(np.int16),
                       PAD >> (0 if i == 0 else 1), mode="edge")
                for i, pl in enumerate(fr)]
    src = [np.asarray(pl).astype(np.int16) for pl in cur]
    r0 = [a[None] for a in pad(f0)]
    r1 = [a[None] for a in pad(f1)]
    return src, r0, r1


def test_adopt_costs_with_list1():
    """Every 16x16 block under its own L0/L1/bi motion and three candidate
    tuples (one per direction): the cost matrix and its argmin."""
    qp = 30
    src, r0, r1 = _l1_scene(3)
    nby, nbx = H // 16, W // 16
    N = nby * nbx
    rng = np.random.default_rng(3)
    by, bx = np.divmod(np.arange(N), nbx)
    xy = np.stack([bx * 16, by * 16], 1).astype(np.int32)
    own_dir = rng.integers(1, 4, N).astype(np.int32)
    own = np.zeros((N, 2, 2), np.int32)
    own[:, 0] = np.array([8, 4]) + rng.integers(-3, 4, (N, 2))
    own[:, 1] = np.array([-8, -4]) + rng.integers(-3, 4, (N, 2))
    cands = [(1, [8, 4], [0, 0]), (2, [0, 0], [-8, -4]),
             (3, [8, 4], [-8, -4])]
    mv_all = [own] + [np.broadcast_to(np.array([m0, m1], np.int32),
                                      (N, 2, 2)) for _, m0, m1 in cands]
    dir_all = [own_dir] + [np.full(N, d, np.int32) for d, _, _ in cands]
    args = (xy, np.concatenate(mv_all), np.concatenate(dir_all),
            np.zeros(4 * N, np.int32), np.full(N, qp, np.int32),
            np.array([14, 5, 5, 5], np.float32),
            jrm.rdoq_rate_consts(2, qp))
    kw = dict(k=4, bd=8, sdh=True, do_rdoq=False, scaling=False, pad=PAD,
              cb_off=0, cr_off=0, psy=2.0)
    with enable_x64():
        want = np.asarray(jrdo._adopt_costs(
            *map(jnp.asarray, src + r0 + r1), *map(jnp.asarray, args),
            **kw))
    got = trdo._adopt_costs(*map(T, src + r0 + r1), *map(T, args),
                            **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=COST_RTOL, atol=0)
    flips = int((got.argmin(0) != want.argmin(0)).sum())
    assert flips == 0
    assert len(np.unique(want.argmin(0))) >= 2


@pytest.mark.parametrize("n", [32, 64])
def test_promo_costs_with_list1(n):
    """One n-CU at a unified motion against four (n/2)-CUs, for L1 and bi
    groups."""
    qp = 30
    src, r0, r1 = _l1_scene(n)
    hn, wn = H // n, W // n
    G = hn * wn
    rng = np.random.default_rng(n)
    ys, xs = np.divmod(np.arange(G), wn)
    xy = np.stack([xs * n, ys * n], 1).astype(np.int32)
    dirm = np.where(np.arange(G) % 2 == 0, 2, 3).astype(np.int32)
    mv4 = np.zeros((G, 4, 2, 2), np.int32)
    mv4[:, :, 0] = np.array([8, 4]) + rng.integers(-3, 4, (G, 4, 2))
    mv4[:, :, 1] = np.array([-8, -4]) + rng.integers(-3, 4, (G, 4, 2))
    args = (xy, mv4, mv4[:, 0], dirm, np.zeros(G, np.int32),
            np.full(G, qp, np.int32), np.full(G, 6, np.float32),
            np.full(G, 34, np.float32), jrm.rdoq_rate_consts(2, qp))
    kw = dict(n=n, bd=8, sdh=True, do_rdoq=False, scaling=False, pad=PAD,
              cb_off=0, cr_off=0, psy=2.0)
    with enable_x64():
        want = jrdo._promo_costs(*map(jnp.asarray, src + r0 + r1),
                                 *map(jnp.asarray, args), **kw)
    got = trdo._promo_costs(*map(T, src + r0 + r1), *map(T, args), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=COST_RTOL, atol=0)
    flips = int(((got[0] < got[1]).numpy()
                 != (np.asarray(want[0]) < np.asarray(want[1]))).sum())
    assert flips == 0
