"""parallel/ of the port (x265_tpu_torch/parallel/): the band step with its
halos and psum on meshes of 4 and 8 tiles that name the CPU several times,
held against the JAX package's (x265_tpu/parallel/tiles.py on the 8
virtual devices of tests/conftest.py) on the same numpy inputs; the
reference's band-edge quirk in both packages; the mesh's intra decisions
equal to the unsharded ones; the Mesh constructors."""
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one torch thread)
from x265_tpu_torch.parallel import mesh as tmesh
from x265_tpu_torch.parallel import tiles as ttiles

S = 16
R = 8


def _port_mesh(n):
    return ttiles.make_tile_mesh(n, devices=["cpu"] * n)


def _jax_mesh(n):
    from x265_tpu.parallel.tiles import make_tile_mesh
    return make_tile_mesh(n)


def _shifted(y, rows=5):
    """y moved `rows` rows down with the top row repeated (real motion
    across band edges, never the ring's wrap)."""
    return np.concatenate([np.repeat(y[:1], rows, axis=0), y[:-rows]])


def _dense_min_sad(y, ref):
    """The whole-frame dense min-SAD over (2R+1)^2 displacements against
    the edge-padded reference (numpy, tests/test_parallel.py's)."""
    H, W = y.shape
    ref_pad = np.pad(ref, R, mode="edge")
    nby, nbx = H // S, W // S
    best = np.full((nby, nbx), 1 << 30, np.int64)
    for dy in range(2 * R + 1):
        for dx in range(2 * R + 1):
            sh = ref_pad[dy:dy + H, dx:dx + W].astype(np.int64)
            sad = np.abs(y - sh).reshape(nby, S, nbx, S).sum(axis=(1, 3))
            best = np.minimum(best, sad)
    return best


@pytest.mark.parametrize("n", [4, 8])
def test_sharded_analysis_matches_cross_band_motion(n):
    """tests/test_parallel.py's first case on the port: every interior
    block finds its 5-row shift through the halos, and the sharded
    min-SAD equals the whole-frame dense sweep everywhere."""
    H, W = S * 2 * n, 128
    y = np.random.default_rng(0).integers(0, 256, (H, W)).astype(np.int32)
    ref = _shifted(y)
    modes, icost, mcost, fc = ttiles.sharded_frame_analysis(
        _port_mesh(n), y, ref, S=S, R=R)
    mcost = mcost.numpy()
    assert mcost.dtype == np.int32
    assert int(mcost[:-1].max()) == 0
    assert np.array_equal(mcost.astype(np.int64), _dense_min_sad(y, ref))
    assert modes.shape[0] == icost.shape[0] == (H // S) * (W // S)
    assert float(fc) >= 0


@pytest.mark.parametrize("n", [4, 8])
def test_sharded_rc_psum_equals_sum_of_bands(n):
    """tests/test_parallel.py's second case on the port."""
    H, W = S * 2 * n, 128
    rng = np.random.default_rng(1)
    y = rng.integers(0, 256, (H, W)).astype(np.int32)
    ref = rng.integers(0, 256, (H, W)).astype(np.int32)
    modes, icost, mcost, fc = ttiles.sharded_frame_analysis(
        _port_mesh(n), y, ref, S=S, R=R)
    manual = float(np.minimum(icost.numpy().reshape(H // S, W // S),
                              mcost.numpy() * 2.0).sum())
    assert abs(float(fc) - manual) / max(1.0, manual) < 1e-5


@pytest.mark.parametrize("n", [4, 8])
def test_sharded_frame_analysis_equals_jax(n):
    """The port's band step against the JAX package's on one textured
    frame and a shifted, noisier reference: mcost and modes exact, icost
    within 1e-4 relative (fp32 sums in another order) with no mode flip,
    frame_cost within 1e-5."""
    from x265_tpu.parallel.tiles import sharded_frame_analysis
    from x265_tpu_torch.utils.testclip import make_clip
    H, W = S * 2 * n, 96
    y = make_clip(W, H, 1, seed=3)[0][0].astype(np.int32)
    noise = np.random.default_rng(2).integers(-3, 4, (H, W))
    ref = np.clip(_shifted(y, 3) + noise, 0, 255).astype(np.int32)
    got = ttiles.sharded_frame_analysis(_port_mesh(n), y, ref, S=S, R=R)
    want = sharded_frame_analysis(_jax_mesh(n), y, ref, S=S, R=R)
    modes, icost, mcost, fc = (np.asarray(t) for t in got)
    jm, ji, jc, jf = (np.asarray(t) for t in want)
    assert np.array_equal(mcost, jc) and mcost.dtype == jc.dtype
    assert np.array_equal(modes, jm)
    np.testing.assert_allclose(icost, ji, rtol=1e-4)
    assert abs(float(fc) - float(jf)) <= 1e-5 * max(1.0, abs(float(jf)))


def test_band_edge_quirk_in_both_packages():
    """The band step analyses each band alone (the reference's
    tiles.py:59), so blocks next to a band edge read edge-replicated
    rows: their modes differ from the whole-frame analysis's. Both
    packages differ at the same blocks, only in block rows next to a band
    edge, and the port copies the quirk."""
    import jax.numpy as jnp
    from x265_tpu.models.intra_frame import frame_intra_analysis as jfia
    from x265_tpu.parallel.tiles import sharded_frame_analysis
    from x265_tpu_torch.models.intra_frame import frame_intra_analysis
    n, H, W = 4, 128, 128
    y = np.random.default_rng(5).integers(0, 256, (H, W)).astype(np.int32)
    band = ttiles.sharded_frame_analysis(_port_mesh(n), y, y, S=S, R=R)
    jband = sharded_frame_analysis(_jax_mesh(n), y, y, S=S, R=R)
    whole = frame_intra_analysis(torch.from_numpy(y), S=S)
    jwhole = jfia(jnp.asarray(y), S=S)
    nby, nbx = H // S, W // S
    diff = (band[0].numpy() != whole[0].numpy()).reshape(nby, nbx)
    jdiff = (np.asarray(jband[0]) != np.asarray(jwhole[0])).reshape(nby,
                                                                    nbx)
    assert np.array_equal(diff, jdiff)
    assert diff.any()
    rows = H // S // n          # block rows a band
    edge = np.zeros(nby, bool)
    for b in range(n):
        edge[b * rows] |= b > 0
        edge[(b + 1) * rows - 1] |= b < n - 1
    assert not diff[~edge].any()


@pytest.mark.parametrize("w,h,n,fast,psy", [
    (192, 128, 4, False, 0.0), (192, 120, 4, True, 2.0),
    (200, 72, 4, False, 1.0)])
def test_mesh_intra_decisions_equal_unsharded_and_jax(w, h, n, fast, psy):
    """mesh_intra_decisions (with its halos) returns exactly the
    unsharded decide_intra_frame_tpu_with_cost's decisions and cost grid
    and the JAX package's mesh_intra_decisions' decisions, also where the
    height does not divide by S * n (band padding, then the crop)."""
    from x265_tpu.parallel.tiles import mesh_intra_decisions as jmid
    from x265_tpu_torch.models.intra_frame import (
        decide_intra_frame_tpu_with_cost)
    from x265_tpu_torch.utils.testclip import make_clip
    y = make_clip(w, h, 1, seed=9)[0][0]
    dec, icost = ttiles.mesh_intra_decisions(_port_mesh(n), y, w, h, 4,
                                             fast, psy)
    one, icost1 = decide_intra_frame_tpu_with_cost(y, w, h, 4, fast, psy,
                                                   device="cpu")
    jdec, jicost = jmid(_jax_mesh(n), y, w, h, 4, fast, psy)
    for a, b, c in ((dec, one, jdec),):
        assert np.array_equal(a.luma_mode8, b.luma_mode8)
        assert np.array_equal(a.cu_log2_map, b.cu_log2_map)
        assert np.array_equal(a.luma_mode8, c.luma_mode8)
        assert np.array_equal(a.cu_log2_map, c.cu_log2_map)
    assert icost.shape == icost1.shape == np.asarray(jicost).shape
    assert np.array_equal(icost, icost1)
    np.testing.assert_allclose(icost, np.asarray(jicost), rtol=1e-4)


def test_mesh_constructors():
    """Mesh: devices as a numpy object array of torch devices, axis names
    and shape as in JAX; make_tile_mesh / make_frame_tile_mesh take CUDA
    devices and raise RuntimeError on a machine with fewer;
    tiles.make_tile_mesh takes repeated devices explicitly; an encoder
    refuses a mesh whose first device is not its own."""
    m = ttiles.make_tile_mesh(4, devices=["cpu"] * 4)
    assert m.axis_names == ("tile",)
    assert m.devices.shape == (4,) and m.devices.size == 4
    assert m.shape == {"tile": 4}
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    ft = tmesh.Mesh([["cpu", "cpu"], ["cpu", "cpu"]], ("frames", "tile"))
    assert ft.shape == {"frames": 2, "tile": 2}
    assert isinstance(ft.devices[1, 0], torch.device)
    with pytest.raises(ValueError):
        tmesh.Mesh(["cpu"] * 2, ("frames", "tile"))
    with pytest.raises(ValueError):
        ttiles.make_tile_mesh(4, devices=["cpu"] * 3)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for n in (have + 1, 4 if have < 4 else have + 1):
        with pytest.raises(RuntimeError, match=f"need {n} devices"):
            tmesh.make_tile_mesh(n)
        with pytest.raises(RuntimeError, match=f"need {n} devices"):
            ttiles.make_tile_mesh(n)
    with pytest.raises(RuntimeError):
        tmesh.make_frame_tile_mesh(2, have // 2 + 1)
    from x265_tpu_torch.api.encoder import Encoder
    from torch_port_util import slice_params
    enc = Encoder(slice_params("x265_tpu_torch", 64, 64), device="cpu")
    with pytest.raises(ValueError, match="first device"):
        enc.attach_mesh(tmesh.Mesh([torch.device("meta")] * 4, ("tile",)))
    enc.attach_mesh(m)
    assert enc.mesh is m
