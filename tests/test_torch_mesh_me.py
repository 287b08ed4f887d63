"""engine/me.motion_fused and tuple_satd under a mesh of 4 tiles that
name the CPU four times: the frame's block rows in bands (kernel 5's
sweeps, kernel 3's lanes and kernel 4 band by band), the references
replicated, the median predictor and the 2x2 modal smoothing on the
gathered field. Bit-identical to mesh=None and to the JAX package's
functions under a 4-device mesh (tests/conftest.py's virtual devices):
the dense search (R=16) and the two-level one (R=57), the bi-prediction
SATD, 192 rows (3 block rows a band, so a band splits a modal pair), and
a height that does not divide by S * 4, which runs unsharded."""
import numpy as np
import pytest

import torch_port_util  # noqa: F401  (one torch thread)
from x265_tpu_torch.engine import me
from x265_tpu_torch.parallel.tiles import make_tile_mesh
from x265_tpu_torch.utils.testclip import make_clip

N_TILES = 4


def _meshes():
    from x265_tpu.parallel.tiles import make_tile_mesh as jax_mesh
    return make_tile_mesh(N_TILES, devices=["cpu"] * N_TILES), \
        jax_mesh(N_TILES)


def _count_bands(monkeypatch):
    """Count the integer searches (one per band and reference)."""
    calls = []
    orig = me._int_stage

    def run(cur, *a):
        calls.append(cur.shape[0])
        return orig(cur, *a)
    monkeypatch.setattr(me, "_int_stage", run)
    return calls


@pytest.mark.parametrize("w,h,R,do_bi,sharded", [
    (128, 192, 16, False, True), (128, 192, 57, True, True),
    (128, 88, 16, True, False)],
    ids=["dense-3rows-a-band", "hme-bi", "unsharded-88"])
def test_motion_fused_mesh_equals_unsharded_and_jax(w, h, R, do_bi, sharded,
                                                    monkeypatch):
    from x265_tpu.engine.me import motion_fused as jmotion_fused
    frames = make_clip(w, h, 3, seed=4)
    cur, refs = frames[1][0], [frames[0][0], frames[2][0]]
    tmesh, jmesh = _meshes()
    kw = dict(S=16, R=R, qp=30, subme=2, do_bi=do_bi)
    calls = _count_bands(monkeypatch)
    got = me.motion_fused(cur, refs, w, h, mesh=tmesh, device="cpu", **kw)
    nby = -(-h // 16)
    assert me._mesh_tiles(tmesh, nby) is not None if sharded else \
        me._mesh_tiles(tmesh, nby) is None
    assert len(calls) == len(refs) * (N_TILES if sharded else 1)
    one = me.motion_fused(cur, refs, w, h, device="cpu", **kw)
    want = jmotion_fused(cur, refs, w, h, mesh=jmesh, **kw)
    for a, b, c in zip(got, one, want):
        assert a.dtype == b.dtype
        assert np.array_equal(a, b)
        assert np.array_equal(a, np.asarray(c))
    if do_bi:
        assert got[3].any()
    # the 2x2 modal smoothing unified some groups on this texture
    mv = got[0][0]
    g = mv[:nby // 2 * 2].reshape(nby // 2, 2, -1, 2, 2)
    assert (g == g[:, :1, :, :1]).all(axis=(1, 3, 4)).any()


@pytest.mark.parametrize("w,h", [(128, 192), (128, 88)],
                         ids=["sharded", "unsharded-88"])
def test_tuple_satd_mesh_equals_unsharded_and_jax(w, h):
    from x265_tpu.engine.me import tuple_satd as jtuple_satd
    frames = make_clip(w, h, 3, seed=6)
    cur = frames[1][0]
    r0, r1 = [frames[0][0]], [frames[2][0]]
    cands = [(1, 0, 0, (5, -3), (0, 0)), (3, 0, 0, (-9, 2), (7, 11)),
             (2, 0, 0, (0, 0), (-200, 300))]
    tmesh, jmesh = _meshes()
    got = me.tuple_satd(cur, r0, r1, cands, w, h, R=16, mesh=tmesh,
                        device="cpu")
    one = me.tuple_satd(cur, r0, r1, cands, w, h, R=16, device="cpu")
    want = jtuple_satd(cur, r0, r1, cands, w, h, R=16, mesh=jmesh)
    assert got.shape == (3, -(-h // 16), w // 16)
    assert np.array_equal(got, one)
    assert np.array_equal(got, np.asarray(want))
