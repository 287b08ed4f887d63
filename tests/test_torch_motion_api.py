"""The standalone motion API (engine/me.py: motion_decide with its dense
and hierarchical integer searches and the --subme rounds, refine_with_mvp,
eval_mvs, smooth_mv_field, bi_cost) against the JAX package on the same
numpy inputs: the cases of tests/test_interp.py (a synthetic quarter-pel
shift), tests/test_inter.py (40-pel motion at merange 57) and
tests/test_preset_tiers.py (the subme tiers); and Lookahead.frame_cost.
Motion vectors are exact;
costs are exact but where the window search's mv cost enters (the HME at
subme 0), which may differ by 2 ulp (XLA:CPU contracts the multiply-add,
ROADMAP Queue 3)."""
import numpy as np
import pytest

import torch_port_util  # noqa: F401  (one torch thread)
from x265_tpu_torch.engine import me as tme


def _jme():
    from x265_tpu.engine import me
    return me


def _shift_case():
    """tests/test_interp.py: the base texture shifted by (5, -2) qpel."""
    from x265_tpu_torch.ops.ref.interp import mc_luma
    h, w = 64, 96
    yy, xx = np.mgrid[0:h, 0:w]
    base = (128 + 80 * np.sin(xx / 7.0) * np.cos(yy / 9.0)).astype(np.int32)
    refp = np.pad(base, 16, mode="edge")
    cur = np.zeros_like(base)
    for y in range(h):
        cur[y] = [mc_luma(refp, 16, x, y, 1, 1, (5, -2))[0, 0]
                  for x in range(w)]
    return cur, base


def _blur_case():
    """tests/test_preset_tiers.py: a 3:1 row blend (quarter-pel motion)."""
    rng = np.random.default_rng(4)
    h, w = 64, 96
    big = rng.integers(0, 200, (h + 16, w + 16)).astype(np.int32)
    big = (big[:-2, :-2] + big[1:-1, :-2] + big[2:, :-2]
           + big[:-2, 1:-1] + big[1:-1, 1:-1] + big[2:, 1:-1]
           + big[:-2, 2:] + big[1:-1, 2:] + big[2:, 2:]) // 9
    ref = big[4:4 + h, 4:4 + w].astype(np.uint8)
    sub = big[4:5 + h, 7:7 + w]
    cur = ((3 * sub[:-1].astype(np.int32) + sub[1:]) // 4).astype(np.uint8)
    return cur, ref


def _shift40_case():
    """tests/test_inter.py: the reference shifted right by 40 pels."""
    rng = np.random.default_rng(3)
    H, W = 128, 192
    ref = rng.integers(0, 256, (H, W)).astype(np.uint8)
    cur = np.concatenate([np.repeat(ref[:, :1], 40, 1), ref[:, :-40]],
                         axis=1)
    return cur, ref


def _both(cur, ref, **kw):
    h, w = np.shape(cur)
    a = tme.motion_decide(cur, ref, w, h, device="cpu", **kw)
    b = _jme().motion_decide(cur, ref, w, h, **kw)
    return a, b


def test_int_search_matches_jax():
    """_int_search: kernel 5's fused entry plus the SAD at the winner
    equals the JAX scan's (index, cost, SAD) triple."""
    import jax.numpy as jnp
    import torch
    rng = np.random.default_rng(5)
    S, R = 8, 5
    cur = rng.integers(0, 256, (32, 48)).astype(np.int16)
    ref = np.pad(rng.integers(0, 256, (32, 48)), R,
                 mode="edge").astype(np.int16)
    dys, dxs = np.mgrid[-R:R + 1, -R:R + 1]
    mvcost = np.float32(2.5) * (tme._mv_bits(4 * dxs.ravel())
                                + tme._mv_bits(4 * dys.ravel()))
    got = tme._int_search(torch.from_numpy(cur), torch.from_numpy(ref),
                          torch.from_numpy(mvcost), S, R)
    want = _jme()._int_search(jnp.asarray(cur), jnp.asarray(ref),
                              jnp.asarray(mvcost), S, R)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("subme", [0, 1, 2, 4, 5])
def test_motion_decide_dense_subme_tiers(subme):
    cur, ref = _blur_case()
    (mv, cost), (jmv, jcost) = _both(cur, ref, S=16, R=8, qp=30,
                                     subme=subme)
    assert mv.dtype == np.int32 and cost.dtype == np.float32
    assert np.array_equal(mv, np.asarray(jmv))
    assert np.array_equal(cost, np.asarray(jcost))


def test_motion_decide_recovers_shift():
    cur, ref = _shift_case()
    (mv, cost), (jmv, jcost) = _both(cur, ref, S=16, R=8, qp=30, subme=2)
    assert np.array_equal(mv, np.asarray(jmv))
    assert np.array_equal(cost, np.asarray(jcost))
    good = (mv[..., 0] == 5) & (mv[..., 1] == -2)
    assert good.mean() > 0.6


@pytest.mark.parametrize("subme", [0, 2])
def test_motion_decide_hme_merange57(subme):
    cur, ref = _shift40_case()
    (mv, cost), (jmv, jcost) = _both(cur, ref, S=16, R=57, qp=32,
                                     subme=subme)
    assert np.array_equal(mv, np.asarray(jmv))
    if subme == 0:
        # the window entry's mv cost: at most 2 ulp
        jcost = np.asarray(jcost)
        ulp = np.spacing(np.abs(jcost).astype(np.float32))
        assert (np.abs(cost - jcost) <= 2 * ulp).all()
        assert (mv[:, 3:, 0] == -160).all() and (mv[:, 3:, 1] == 0).all()
    else:
        assert np.array_equal(cost, np.asarray(jcost))


def test_aux_bundle_functions():
    """return_aux and the functions over its bundle: eval_mvs,
    refine_with_mvp, smooth_mv_field and bi_cost (the second reference
    the shift case's current picture)."""
    cur, ref = _shift_case()
    h, w = cur.shape
    jme = _jme()
    mv, cost, aux = tme.motion_decide(cur, ref, w, h, S=16, R=8, qp=30,
                                      subme=2, return_aux=True, device="cpu")
    jmv, jcost, jaux = jme.motion_decide(cur, ref, w, h, S=16, R=8, qp=30,
                                         subme=2, return_aux=True)
    assert np.array_equal(mv, np.asarray(jmv))
    assert aux["margin"] == jaux["margin"] and aux["lam"] == jaux["lam"]
    assert np.array_equal(aux["bxy"], np.asarray(jaux["bxy"]))
    assert np.array_equal(aux["planes"].numpy(), np.asarray(jaux["planes"]))
    # eval_mvs at the found field and at a perturbed one
    rng = np.random.default_rng(8)
    mv2 = mv + rng.integers(-3, 4, mv.shape).astype(np.int32)
    for m in (mv, mv2):
        assert np.array_equal(tme.eval_mvs(aux, m),
                              np.asarray(jme.eval_mvs(jaux, m)))
    # refine against the median predictor, subme 0 and 2
    mvp = tme.mv_field_median3(mv2)
    for subme in (0, 2):
        a = tme.refine_with_mvp(aux, mv2, mvp, subme=subme)
        b = jme.refine_with_mvp(jaux, mv2, mvp, subme=subme)
        assert np.array_equal(a[0], np.asarray(b[0]))
        assert np.array_equal(a[1], np.asarray(b[1]))
    # the 2x2 modal smoothing of the perturbed field: some groups change
    sm = tme.smooth_mv_field(mv2, cost, aux, aux["lam"])
    assert np.array_equal(sm, jme.smooth_mv_field(mv2, cost, jaux,
                                                  jaux["lam"]))
    assert not np.array_equal(sm, mv2)
    # bi-prediction from two bundles, with and without predictors
    mv1, _, aux1 = tme.motion_decide(cur, cur, w, h, S=16, R=8, qp=30,
                                     subme=2, return_aux=True, device="cpu")
    jmv1, _, jaux1 = jme.motion_decide(cur, cur, w, h, S=16, R=8, qp=30,
                                       subme=2, return_aux=True)
    assert np.array_equal(mv1, np.asarray(jmv1))
    for kw in ({}, {"mvp0": mvp, "mvp1": np.zeros_like(mvp)}):
        a = tme.bi_cost(mv2, aux, mv1, aux1, **kw)
        b = jme.bi_cost(mv2, jaux, mv1, jaux1, **kw)
        assert a.dtype == np.float32
        assert np.array_equal(a, np.asarray(b))


def test_return_aux_needs_subpel():
    cur, ref = _blur_case()
    with pytest.raises(ValueError):
        tme.motion_decide(cur, ref, 96, 64, R=8, subme=0, return_aux=True,
                          device="cpu")


def test_lookahead_frame_cost_matches_jax():
    """Lookahead.frame_cost: the first value of frame_costs, on a first
    (intra only) and two following pictures."""
    from x265_tpu.engine.lookahead import Lookahead as JLookahead
    from x265_tpu_torch.engine.lookahead import Lookahead
    cur, ref = _shift_case()
    blur, _ = _blur_case()
    la = Lookahead(96, 64, device="cpu")
    jla = JLookahead(96, 64)
    for i, y in enumerate((ref, cur, blur)):
        y = np.asarray(y, np.uint8)
        got = la.frame_cost(y, i == 0)
        want = jla.frame_cost(y, i == 0)
        assert float(got) == float(want), i
