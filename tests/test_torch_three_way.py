"""The finalizer split at Main10 (tests/test_finalizer_split.py): the
port's streams with and without the device's inter residual equal each
other and the JAX package's (the committed record of golden case
split_main10); and the 64x64-CU three-way check of tests/test_cu64.py:
the native walk, the device residual and the Python oracle writer
(Encoder.use_native = False) give the same bytes, the JAX package's."""
import numpy as np

from test_torch_finalizer_split import split_streams
from torch_port_util import _smooth_noise, switch_streams


def test_split_streams_identical_main10():
    off, on = split_streams("split_main10")
    assert off == on


def _cu64_clip(n=3, w=192, h=128, shift=2, noise=0, seed=11):
    """tests/test_cu64.py's textured frames under uniform global motion,
    a smooth brightness delta growing with the frame index."""
    rng = np.random.default_rng(seed)
    tex = (_smooth_noise(h, w, 32, rng) + 0.6 * _smooth_noise(h, w, 16, rng)
           + 0.3 * _smooth_noise(h, w, 8, rng))
    base = np.clip(128 + 55 * tex / 1.4, 0, 255).astype(int)
    delta = _smooth_noise(h, w, 64, np.random.default_rng(seed + 100))
    out = []
    for i in range(n):
        y = np.roll(base, shift * i, axis=1)
        if noise:
            y = y + np.rint(noise * i * delta).astype(int)
        y = np.clip(y, 0, 255)
        out.append((y.astype(np.uint8),
                    np.clip(120 + (y[::2, ::2] >> 3), 0, 255)
                    .astype(np.uint8),
                    np.full((h // 2, w // 2), 130, np.uint8)))
    return out


def _cu64_params(mod):
    p = mod.param_default_preset("medium")
    p.rc_mode, p.qp = mod.RC_CQP, 10
    p.bframes = 0
    p.sao = False
    p.aq_mode = 0
    p.cu_tree = False
    p.scenecut = 0
    p.ref = 1
    return p


def _force64(seen):
    """tests/test_cu64.py's force64: one motion field for every block and
    no promotion gates, so that the 64x64 coding paths run; records each
    P picture's CU map."""
    def setup(enc):
        orig32, orig64 = enc._merge_cu32, enc._merge_cu64

        def unify(dec):
            if dec.inter8 is None or not dec.inter8.any():
                return
            sel = dec.inter8.astype(bool)
            flat = dec.mv8[sel].reshape(int(sel.sum()), -1)
            vals, counts = np.unique(flat, axis=0, return_counts=True)
            dec.mv8[:] = vals[counts.argmax()].reshape(2, 2)
            dec.inter8[:] = True
            dec.dir8[:] = 1
            if dec.ref8 is not None:
                dec.ref8[:] = 0
            dec.cu_log2_map[:] = 4

        def m32(dec, satd16=None, qp=None, rd_ctx=None):
            unify(dec)
            return orig32(dec)
        enc._merge_cu32 = m32
        enc._merge_cu64 = (
            lambda dec, satd16=None, qp=None, rd_ctx=None: orig64(dec))
        orig_p = enc._p_decisions

        def spy(*a, **k):
            dec = orig_p(*a, **k)
            seen.append(dec.cu_log2_map.copy())
            return dec
        enc._p_decisions = spy
    return setup


def test_cu64_residual_three_way_bitexact():
    """64x64 CUs with residual (the implicit 4x32 TU split): the native
    walk, the device residual and the Python writer give the same bytes,
    the JAX package's, and the stream decodes to the recon. The JAX
    package encodes here: the patched merges are no golden case."""
    from x265_tpu.api import params as JP
    from x265_tpu.api.encoder import Encoder as JEncoder
    from x265_tpu_torch.decoder.decoder import HEVCDecoder
    seen = []
    frames = _cu64_clip(n=3, shift=2, noise=4, seed=5)
    a, b, c = switch_streams(
        _cu64_params, frames,
        [{"use_tpu_residual": False}, {},
         {"use_native": False, "use_tpu_residual": False}],
        setup=_force64(seen))
    p = _cu64_params(JP)
    p.height, p.width = frames[0][0].shape
    jenc = JEncoder(p)
    _force64(seen)(jenc)
    jax = jenc.encode(frames)
    assert any((m == 6).any() for m in seen), "no 64x64 CU promoted"
    assert a == b == c == jax
    ours = HEVCDecoder().decode(a)
    mse = np.mean((ours[-1].y - frames[-1][0].astype(np.int32)) ** 2)
    assert mse < 12.0, mse
