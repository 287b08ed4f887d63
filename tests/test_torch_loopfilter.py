"""models/loopfilter.py and hevc/sao.py of the port against the JAX
package and against the numpy reference (hevc/deblock.py): deblocked
planes, SAO statistics and SAO apply, all integer, all exact; and the
boundary strengths of ops.cuda_kernels.deblock_bs's plain version against
hevc.deblock.derive_bs, branch by branch."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from x265_tpu.hevc import sao as jsao
from x265_tpu.models import loopfilter as jlf
from x265_tpu_torch.hevc import sao as tsao
from x265_tpu_torch.hevc.deblock import NOPOC, deblock_frame, derive_bs
from x265_tpu_torch.models import loopfilter as tlf
from x265_tpu_torch.ops import cuda_kernels
from x265_tpu_torch.utils import convert
import deblock_bs_cases
import torch_port_util  # noqa: F401  (one torch thread)


def _state(rng, h, w, with_motion):
    """Random CU grid, cbf, motion and reference maps on the 4x4 grid,
    carried into both packages through utils.convert."""
    h4, w4 = (h + 3) // 4, (w + 3) // 4
    cl4 = rng.choice([3, 4, 5], size=(h4, w4))
    xs = (np.arange(w4) * 4)[None, :]
    ys = (np.arange(h4) * 4)[:, None]
    is_intra4 = rng.random((h4, w4)) < (0.3 if with_motion else 1.0)
    mv4 = refpoc4 = None
    if with_motion:
        mv4 = rng.integers(-32, 32, (h4, w4, 2, 2)).astype(np.int32)
        refpoc4 = rng.choice([0, 4, NOPOC], size=(h4, w4, 2))
        refpoc4[..., 0] = np.where(is_intra4, NOPOC, refpoc4[..., 0])
    bypass4 = rng.random((h4, w4)) < 0.05
    return convert.deblock_state_from_numpy(
        h, w, (xs % (1 << cl4)) == 0, (ys % (1 << cl4)) == 0,
        rng.random((h4, w4)) < 0.4, bypass4, is_intra4, mv4, refpoc4)


def _planes(rng, h, w):
    # smooth-ish content, so strong, weak and no filtering all occur
    base = rng.integers(60, 200, (h // 8 + 2, w // 8 + 2))
    y = np.kron(base, np.ones((8, 8), np.int64))[:h, :w]
    y = np.clip(y + rng.integers(-6, 7, (h, w)), 0, 255).astype(np.int32)
    cb = np.clip(y[::2, ::2] // 2 + 60 + rng.integers(-4, 5, (h // 2, w // 2)),
                 0, 255).astype(np.int32)
    cr = np.clip(250 - y[::2, ::2] // 2 + rng.integers(-4, 5,
                                                        (h // 2, w // 2)),
                 0, 255).astype(np.int32)
    return y, cb, cr


@pytest.mark.parametrize("h,w,with_motion,qp_map", [
    (96, 128, False, False), (96, 128, True, False), (96, 128, True, True),
    (120, 200, True, True)])                 # not a CTU multiple
def test_deblock_matches_jax_and_numpy_reference(h, w, with_motion, qp_map):
    rng = np.random.default_rng(3 + with_motion + 2 * qp_map + h)
    y, cb, cr = _planes(rng, h, w)
    st, is_intra4, mv4, refpoc4 = _state(rng, h, w, with_motion)
    qp = (rng.integers(18, 40, st.cbf4.shape).astype(np.int32)
          if qp_map else 30)
    args = (st, is_intra4, mv4, refpoc4, qp, 1, -1, 1, -1, 8)
    ref = deblock_frame(y.copy(), cb.copy(), cr.copy(), *args)
    want = jlf.deblock_frame_device((y, cb, cr), *args)
    got = tlf.deblock_frame_device((y, cb, cr), *args, device="cpu")
    for r, j, t in zip(ref, want, got):
        assert t.dtype == np.int32
        assert np.array_equal(np.asarray(j, np.int32), t)
        assert np.array_equal(np.asarray(r, np.int32), t)
    assert (got[0] != y).any()                # the filter did something
    # sync=False: a finisher; keep_device: int16 tensors
    fin = tlf.deblock_frame_device((y, cb, cr), *args, sync=False,
                                   keep_device=True, device="cpu")
    kept = fin()
    for t, k in zip(got, kept):
        assert isinstance(k, torch.Tensor) and k.dtype == torch.int16
        assert np.array_equal(k.numpy().astype(np.int32), t)


@pytest.mark.parametrize("h,w,ctb_log2", [(64, 128, 6), (120, 200, 6),
                                          (120, 200, 5)])
def test_deblock_with_sao_stats_matches_jax(h, w, ctb_log2):
    rng = np.random.default_rng(9 + h + ctb_log2)
    y, cb, cr = _planes(rng, h, w)
    src = tuple(np.clip(p + rng.integers(-3, 4, p.shape), 0, 255)
                .astype(np.uint8) for p in (y, cb, cr))
    st, is_intra4, mv4, refpoc4 = _state(rng, h, w, True)
    args = (st, is_intra4, mv4, refpoc4, 30, 0, 0, 0, 0, 8)
    want = jlf.deblock_frame_device((y, cb, cr), *args, sao_src=src,
                                    ctb_log2=ctb_log2)
    got = tlf.deblock_frame_device((y, cb, cr), *args, sao_src=src,
                                   ctb_log2=ctb_log2, device="cpu")
    for j, t in zip(want[:3], got[:3]):
        assert np.array_equal(np.asarray(j, np.int32), t)
    ctb = 1 << ctb_log2
    cy, cx = -(-h // ctb), -(-w // ctb)
    for pl in range(3):
        for k in range(4):
            a = np.asarray(want[3][pl][k])
            b = got[3][pl][k]
            assert b.dtype == np.int32 and a.shape == b.shape
            assert np.array_equal(a, b), (pl, k)
    # the numpy statistics of the same deblocked plane
    ecnt, esum = tsao._eo_stats(src[0].astype(np.int64),
                                got[0].astype(np.int64), cy, cx, ctb)
    assert np.array_equal(got[3][0][0], ecnt)
    assert np.array_equal(got[3][0][1], esum)
    # the frame statistics entry, against _frame_stats_jax
    js = jsao._frame_stats_jax(
        *(jnp.asarray(np.asarray(a, np.int32))
          for pr in zip(src, got[:3]) for a in pr), cy, cx, ctb, 8)
    ts = tsao.stats_to_host(tsao._frame_stats_dev(
        *(torch.from_numpy(np.asarray(a, np.int32))
          for pr in zip(src, got[:3]) for a in pr), cy, cx, ctb, 8))
    for pl in range(3):
        for k in range(4):
            assert np.array_equal(np.asarray(js[pl][k]), ts[pl][k])
    # the decision from them is the JAX package's
    sp_j = jsao.analyze_frame(src, got[:3], ctb_log2, 30, 8, stats=want[3])
    sp_t = tsao.analyze_frame(src, got[:3], ctb_log2, 30, 8, stats=got[3])
    sp_n = tsao.analyze_frame(src, got[:3], ctb_log2, 30, 8, device="cpu")
    for k, v in convert.sao_params_to_numpy(sp_t).items():
        assert np.array_equal(v, getattr(sp_j, k)), k
        assert np.array_equal(v, getattr(sp_n, k)), k


@pytest.mark.parametrize("h,w,ctb_log2", [(64, 128, 6), (120, 200, 5)])
def test_sao_apply_device_matches_apply_frame(h, w, ctb_log2):
    rng = np.random.default_rng(31 + h)
    y, cb, cr = _planes(rng, h, w)
    ctb = 1 << ctb_log2
    cy, cx = -(-h // ctb), -(-w // ctb)
    typ = rng.integers(0, 3, (2, cy, cx))
    maps = dict(
        type_y=typ[0], type_c=typ[1],
        class_y=np.where(typ[0] == 2, rng.integers(0, 4, (cy, cx)),
                         rng.integers(0, 29, (cy, cx))),
        class_cb=np.where(typ[1] == 2, rng.integers(0, 4, (cy, cx)),
                          rng.integers(0, 29, (cy, cx))),
        off_y=rng.integers(-7, 8, (cy, cx, 4)),
        off_cb=rng.integers(-7, 8, (cy, cx, 4)),
        off_cr=rng.integers(-7, 8, (cy, cx, 4)))
    maps["class_cr"] = np.where(typ[1] == 2, maps["class_cb"],
                                rng.integers(0, 29, (cy, cx)))
    sp = convert.sao_params_from_numpy(**maps)
    sp_j = jsao.SaoParams(**convert.sao_params_to_numpy(sp))
    want_np = tsao.apply_frame((y, cb, cr), sp, ctb_log2, 8)
    want_j = jlf.sao_apply_device(
        tuple(jnp.asarray(p.astype(np.int16)) for p in (y, cb, cr)), sp_j,
        ctb_log2, 8)
    got = tlf.sao_apply_device(
        tuple(torch.from_numpy(p.astype(np.int16)) for p in (y, cb, cr)),
        sp, ctb_log2, 8)
    for n_, j, t in zip(want_np, want_j, got):
        assert t.dtype == torch.int16
        assert np.array_equal(np.asarray(n_, np.int32),
                              t.numpy().astype(np.int32))
        assert np.array_equal(np.asarray(j, np.int32),
                              t.numpy().astype(np.int32))
    assert any(not np.array_equal(t.numpy(), p)
               for t, p in zip(got, (y, cb, cr)))


def _bs_both(edge_v, edge_h, intra, cbf, mv4, refpoc4):
    """(want_v, want_h) from derive_bs; (got_v, got_h) from the plain
    version on the narrow inputs, and again through the loop filter's
    packing (models.loopfilter._boundary_strengths on the CPU)."""
    want = [derive_bs(e, intra, cbf, mv4, refpoc4, vertical=v)
            for e, v in ((edge_v, True), (edge_h, False))]
    flags = torch.from_numpy(cuda_kernels.deblock_bs_flags(
        edge_v, edge_h, intra, cbf))
    got = cuda_kernels.deblock_bs_plain(
        flags, torch.from_numpy(mv4.astype(np.int16)),
        torch.from_numpy(refpoc4.astype(np.int32)))
    st = convert.deblock_state_from_numpy(
        4 * intra.shape[0], 4 * intra.shape[1], edge_v, edge_h, cbf)[0]
    packed = tlf._boundary_strengths(st, intra, mv4, refpoc4,
                                     torch.device("cpu"))
    return want, got, packed


@pytest.mark.parametrize("vertical", [True, False])
@pytest.mark.parametrize("case", [*deblock_bs_cases.CASES, "random_30x50",
                                  "random_270x480"])
def test_deblock_bs_plain_equals_derive_bs(case, vertical):
    """Every branch of the derivation, one edge a case, in both directions
    (the expected bS checked where the case puts it); then random maps at
    a size that is not a CTU multiple (120x200) and at 1080p's grid."""
    if case.startswith("random"):
        h4, w4 = map(int, case.split("_")[1].split("x"))
        rng = np.random.default_rng(h4 + vertical)
        maps = deblock_bs_cases.random_maps(rng, h4, w4)
        pos = want_at = None
    else:
        *maps, pos, want_at = deblock_bs_cases.case_maps(case, vertical)
    want, got, packed = _bs_both(*maps)
    for w, g, k in zip(want, got, packed):
        assert g.dtype == torch.int32 and k.dtype == torch.int32
        assert np.array_equal(g.numpy(), w)
        assert np.array_equal(k.numpy(), w)
    d = 0 if vertical else 1
    if pos is not None:
        assert want[d][pos] == want_at
    else:                       # the random maps reach every strength
        assert set(np.unique(want[d])) == {0, 1, 2}
    assert not want[0][:, 0].any() and not want[1][0, :].any()
