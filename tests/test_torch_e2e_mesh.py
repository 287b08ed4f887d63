"""Mesh-attached encodes (Encoder.attach_mesh) at the golden cases'
size: the port's tiles on the CPU four times. Each golden case under a
mesh (utils/testclip.GOLDEN_MESH) equals the JAX package's mesh stream
(its committed golden record, encoded on tests/conftest.py's virtual
devices) and the port's own unsharded stream, and decodes to the
encoder's recon; under a mesh the device inter residual is refused by
name in the port, where the JAX package's raises while tracing."""
import numpy as np
import pytest

from torch_port_util import (assert_decodes_to_recon, golden_encoders,
                             recon_collector)
from x265_tpu_torch.utils import testclip


def _spy_mesh_paths(monkeypatch):
    """Count the mesh's intra analyses and the banded motion searches."""
    from x265_tpu_torch.engine import me
    from x265_tpu_torch.parallel import tiles
    seen = {"intra": 0, "motion_bands": 0}
    intra, mesh_tiles = tiles.mesh_intra_decisions, me._mesh_tiles

    def count_intra(*a, **kw):
        seen["intra"] += 1
        return intra(*a, **kw)

    def count_tiles(mesh, nby):
        t = mesh_tiles(mesh, nby)
        seen["motion_bands"] += len(t or ())
        return t
    monkeypatch.setattr(tiles, "mesh_intra_decisions", count_intra)
    monkeypatch.setattr(me, "_mesh_tiles", count_tiles)
    return seen


def _unsharded_stream(name, frames):
    from x265_tpu_torch.api import params as TP
    from x265_tpu_torch.api.encoder import Encoder
    enc = Encoder(testclip.golden_params(name, TP), device="cpu")
    for k, v in testclip.GOLDEN_ATTRS.get(name, {}).items():
        setattr(enc, k, v)
    recon_collector(enc)
    stream = enc.headers()
    for f in frames:
        stream += enc.encode_frame(*f)
    return stream + enc.flush()


def test_mesh_allintra_lossless_golden(monkeypatch):
    """The JAX package's multi-chip dry run's all-intra shape: 128x64,
    16x16 CTUs, a slice a band, two pictures through encode_frame."""
    seen = _spy_mesh_paths(monkeypatch)
    name = "mesh4_allintra_lossless"
    enc, stream, recons, gold, frames = golden_encoders(name)
    assert enc.mesh is not None
    assert seen["intra"] == len(frames)
    assert stream == _unsharded_stream(name, frames)
    assert_decodes_to_recon(stream, recons, len(frames))
    for rec, f in zip(recons, frames):           # lossless
        assert np.array_equal(np.asarray(rec[0]), f[0])


def test_mesh_medium_cpu_residual_golden(monkeypatch):
    """medium under CQP with two B frames, four slices, no device
    residual: the mesh runs the intra analysis and the motion search of
    the P and the referenced B picture in bands."""
    seen = _spy_mesh_paths(monkeypatch)
    name = "mesh4_medium_cpu_residual"
    enc, stream, recons, gold, frames = golden_encoders(name)
    assert not enc.use_tpu_residual and enc.mesh is not None
    types = "".join(s["type"] for s in enc.frame_stats)
    assert "P" in types and "B" in types
    assert seen["intra"] >= 2 and seen["motion_bands"] >= 8
    assert stream == _unsharded_stream(name, frames)
    assert_decodes_to_recon(stream, recons, len(frames))


def test_mesh_refuses_the_device_residual():
    """With the device residual on, the first inter picture under a mesh
    raises: NotImplementedError naming the reference's fault in the port,
    the JAX package's own error (TracerBoolConversionError while tracing
    _inter_multi) there."""
    from x265_tpu.api import params as JP
    from x265_tpu.api.encoder import Encoder as JEncoder
    from x265_tpu.parallel.tiles import make_tile_mesh as jax_mesh
    from x265_tpu_torch.api import params as TP
    from x265_tpu_torch.api.encoder import Encoder
    name = "mesh4_medium_cpu_residual"
    frames = testclip.golden_clip(name)
    enc = Encoder(testclip.golden_params(name, TP), device="cpu")
    enc.attach_mesh(testclip.golden_mesh(name, "cpu"))
    assert enc.use_tpu_residual
    with pytest.raises(NotImplementedError, match="_inter_multi"):
        enc.encode(frames)
    assert [s["type"] for s in enc.frame_stats] == ["I"]
    jenc = JEncoder(testclip.golden_params(name, JP))
    jenc.attach_mesh(jax_mesh(4))
    with pytest.raises(Exception):
        jenc.encode(frames)
    assert [s["type"] for s in jenc.frame_stats] == ["I"]
