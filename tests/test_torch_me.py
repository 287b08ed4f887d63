"""engine/me.py of the port against the JAX package: motion vectors and
SATD exact, fp32 costs to 1e-4 relative, and the integer mv-bits form
equal to the float form over the whole mv range."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from x265_tpu.engine import me as jme
from x265_tpu_torch.engine import me as tme
from torch_port_util import make_clip

W, H = 192, 128


def _pair(seed, step=(2, 3)):
    fr = make_clip(W, H, 2, seed, step)
    rng = np.random.default_rng(seed + 100)
    cur = np.clip(fr[1][0].astype(np.int32)
                  + rng.integers(-3, 4, (H, W)), 0, 255).astype(np.uint8)
    return cur, fr[0][0]


def _pair_hard(seed, noise=2, blur=10):
    """Per-block quarter-pel motion on content whose contrast rises from
    almost flat to textured across the picture, under light noise: on
    the flat side many blocks snap to the predictor and 2x2 groups
    accept the modal vector, on the textured side they do not, so both
    outcomes of both thresholds occur (checked when this was written:
    3-7 of 96 blocks change by snapping, 1-6 of 24 groups smooth)."""
    rng = np.random.default_rng(seed)
    base = make_clip(W + 32, H + 32, 1, seed)[0][0].astype(np.float32)
    for _ in range(blur):
        base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)
                + np.roll(base, -1, 0) + np.roll(base, -1, 1)) / 5
    base = ((base - base.mean())
            * np.linspace(0.15, 1.2, base.shape[1])[None, :] + 120)
    ref = base[16:16 + H, 16:16 + W]
    cur = np.zeros((H, W), np.float32)

    def sh(by, bx, dy, dx):
        return base[16 + by + dy:32 + by + dy, 16 + bx + dx:32 + bx + dx]

    for by in range(0, H, 16):
        for bx in range(0, W, 16):
            wx = rng.integers(0, 3) / 4.0
            wy = rng.integers(0, 3) / 4.0
            cur[by:by + 16, bx:bx + 16] = (
                (1 - wy) * ((1 - wx) * sh(by, bx, 1, 1)
                            + wx * sh(by, bx, 1, 2))
                + wy * ((1 - wx) * sh(by, bx, 2, 1)
                        + wx * sh(by, bx, 2, 2)))
    cur = cur + rng.integers(-noise, noise + 1, (H, W))
    return (np.clip(np.rint(cur), 0, 255).astype(np.uint8),
            np.clip(np.rint(ref), 0, 255).astype(np.uint8))


@pytest.mark.parametrize("R,subme,step", [(57, 1, (2, 3)), (16, 2, (1, -2)),
                                          (57, 3, (9, 14)), (57, 1, None),
                                          (16, 2, None), (16, 3, None)])
def test_motion_fused(R, subme, step):
    cur, ref = _pair(R + subme, step) if step else _pair_hard(subme)
    mj, cj, sj, bj = jme.motion_fused(cur, [ref.astype(np.int32)], W, H,
                                      R=R, qp=30, subme=subme, slack=48.0)
    mt, ct, st, bt = tme.motion_fused(cur, [ref.astype(np.int32)], W, H,
                                      R=R, qp=30, subme=subme, slack=48.0,
                                      device="cpu")
    assert np.any(mj != 0)                       # the clip really moves
    assert np.array_equal(mt, mj) and mt.dtype == mj.dtype
    assert np.array_equal(st, sj) and st.dtype == sj.dtype
    np.testing.assert_allclose(ct, cj, rtol=1e-4)
    assert ct.dtype == cj.dtype
    assert np.array_equal(bt, bj)


def test_motion_fused_two_refs_and_device_handles():
    from x265_tpu_torch.utils.convert import reference_from_numpy
    fr = make_clip(W, H, 3, 5)
    cur = fr[2][0]
    refs = [fr[1][0].astype(np.int32), fr[0][0].astype(np.int32)]
    mj, cj, sj, _ = jme.motion_fused(cur, refs, W, H, R=57, qp=30, subme=1)
    handles = [reference_from_numpy(f, device="cpu") for f in fr[1::-1]]
    mt, ct, st, _ = tme.motion_fused(cur, handles, W, H, R=57, qp=30,
                                     subme=1, device="cpu")
    assert np.array_equal(mt, mj) and np.array_equal(st, sj)
    np.testing.assert_allclose(ct, cj, rtol=1e-4)


def test_tuple_satd_exact():
    cur, ref = _pair(7)
    cands = [(1, 0, 0, (12, 8), (0, 0)), (1, 0, 0, (-5, 3), (0, 0)),
             (1, 0, 0, (0, 0), (0, 0))]
    want = jme.tuple_satd(cur, [ref.astype(np.int32)], [], cands, W, H,
                          R=57)
    got = tme.tuple_satd(cur, [ref.astype(np.int32)], [], cands, W, H,
                         R=57, device="cpu")
    assert got.shape == want.shape == (3, H // 16, W // 16)
    assert np.array_equal(got, want)


def test_phase_planes_and_int_stage_exact():
    cur, ref = _pair(11)
    rp = np.pad(ref, ((5, 6), (5, 6)), mode="edge")
    want = np.asarray(jme._phase_planes(jnp.asarray(rp), 255))
    got = tme._phase_planes(torch.from_numpy(rp), 255)
    assert got.dtype == torch.int16 and np.array_equal(got.numpy(), want)
    R = 6
    dys, dxs = np.mgrid[-R:R + 1, -R:R + 1]
    mvc = (2.3 * (jme._mv_bits(4 * dxs.ravel())
                  + jme._mv_bits(4 * dys.ravel()))).astype(np.float32)
    rR = np.pad(ref, R, mode="edge")
    want = np.asarray(jme._int_stage(jnp.asarray(cur), jnp.asarray(rR),
                                     jnp.asarray(mvc), 16, R))
    got = tme._int_stage(torch.from_numpy(cur), torch.from_numpy(rR),
                         torch.from_numpy(mvc), 16, R)
    assert np.array_equal(got.numpy(), want)


def test_int_stage_first_minimum_on_flat_content():
    """Every displacement ties on a flat picture: the first one in
    dy-major order must win, as in the reference scan."""
    cur = np.full((32, 32), 90, np.uint8)
    R = 3
    rR = np.full((32 + 2 * R, 32 + 2 * R), 90, np.uint8)
    mvc = np.zeros((2 * R + 1) ** 2, np.float32)
    want = np.asarray(jme._int_stage(jnp.asarray(cur), jnp.asarray(rR),
                                     jnp.asarray(mvc), 16, R))
    got = tme._int_stage(torch.from_numpy(cur), torch.from_numpy(rR),
                         torch.from_numpy(mvc), 16, R).numpy()
    assert np.array_equal(got, want)
    assert np.all(got == -R)


def test_mv_bits_integer_form_equals_float_form():
    a = np.arange(0, 1 << 16, dtype=np.int64)   # far beyond any mv here
    want = jme._mv_bits(a)
    got = tme._mv_bits_t(torch.from_numpy(a)).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got, want)
    # the traced float32 form the reference uses inside its scans
    f32 = np.asarray(2 * jnp.floor(jnp.log2(
        2 * jnp.asarray(a[:4096]).astype(jnp.float32) + 1)) + 1)
    assert np.array_equal(got[:4096], f32)
    assert np.array_equal(tme._mv_bits(a), want)


def test_dominant_tuples_same_as_reference():
    rng = np.random.default_rng(0)
    mv = rng.integers(-2, 2, (8, 12, 2, 2)).astype(np.int32)
    mv[:, :, 1] = 0
    d = np.ones((8, 12), np.int32)
    r = np.zeros((8, 12), np.int32)
    inter = rng.random((8, 12)) < 0.8
    assert (tme.dominant_tuples(d, mv, r, inter)
            == jme.dominant_tuples(d, mv, r, inter))


def test_bi_search_raises():
    """The bi-prediction search averages the first two references' best
    predictions: with one reference it refuses (tests/test_torch_bframes.py
    holds the search itself against the JAX package)."""
    cur, ref = _pair(1)
    with pytest.raises(ValueError, match="two references"):
        tme.motion_fused(cur, [ref], W, H, do_bi=True, device="cpu")


def test_dense_search_r57_four_refs_subme3():
    """The slow preset's search: `--me star` forces the dense integer
    sweep (kernel 5's argmin entry, one launch a reference) at merange 57
    over four references, then subme 3's refinement; vectors and SATDs
    exact, costs as in test_motion_fused."""
    fr = make_clip(W, H, 5, 21, (3, 9))
    cur = fr[4][0]
    refs = [f[0].astype(np.int32) for f in fr[3::-1]]
    mj, cj, sj, _ = jme.motion_fused(cur, refs, W, H, R=57, qp=27,
                                     subme=3, force_dense=True)
    mt, ct, st, _ = tme.motion_fused(cur, refs, W, H, R=57, qp=27,
                                     subme=3, force_dense=True,
                                     device="cpu")
    assert mt.shape == mj.shape and mt.shape[0] == 4
    assert np.array_equal(mt, mj) and np.array_equal(st, sj)
    np.testing.assert_allclose(ct, cj, rtol=1e-4)
    # the farther references moved farther: the dense sweep found vectors
    # beyond the +-7 window of the hierarchical search
    assert np.abs(mj[3]).max() > 4 * 7


def test_dense_int_stage_r57_exact_and_flat_first_minimum():
    """_int_stage at the dense shape (S=16, R=57) with the encoder's mv
    cost, and on flat content with zero cost, where d = 0 (dy = dx = -57,
    the scan's first displacement) must win."""
    cur, ref = _pair(31, (6, 11))
    R = 57
    dys, dxs = np.mgrid[-R:R + 1, -R:R + 1]
    mvc = (2.8 * (jme._mv_bits(4 * dxs.ravel())
                  + jme._mv_bits(4 * dys.ravel()))).astype(np.float32)
    rR = np.pad(ref, R, mode="edge")
    want = np.asarray(jme._int_stage(jnp.asarray(cur), jnp.asarray(rR),
                                     jnp.asarray(mvc), 16, R))
    got = tme._int_stage(torch.from_numpy(cur), torch.from_numpy(rR),
                         torch.from_numpy(mvc), 16, R).numpy()
    assert np.array_equal(got, want) and np.any(want != 0)
    flat = np.full_like(cur, 77)
    fR = np.full_like(rR, 77)
    zero = np.zeros_like(mvc)
    got = tme._int_stage(torch.from_numpy(flat), torch.from_numpy(fR),
                         torch.from_numpy(zero), 16, R).numpy()
    want = np.asarray(jme._int_stage(jnp.asarray(flat), jnp.asarray(fR),
                                     jnp.asarray(zero), 16, R))
    assert np.array_equal(got, want) and np.all(got == -R)
