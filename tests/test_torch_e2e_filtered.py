"""The filtered low-latency path at a size that is no multiple of the CTU
or of 16 (200x120): fast + zerolatency, byte for byte against the JAX
package, and the presets between ultrafast and fast decoded back by the
port's decoder. A file of its own: a new picture size makes the JAX
package compile everything again."""
import numpy as np
import pytest

from x265_tpu.api import params as JP
from x265_tpu.api.encoder import Encoder as JEncoder
from x265_tpu_torch.api import params as TP
from x265_tpu_torch.api.encoder import Encoder as TEncoder
from x265_tpu_torch.decoder.decoder import HEVCDecoder
from x265_tpu_torch.utils.testclip import make_ramp_clip
import torch_port_util  # noqa: F401  (one torch thread)

W, H = 200, 120


def _params(P, preset, **extra):
    p = P.param_default_preset(preset, "zerolatency")
    opts = {"qp": "30", "scenecut": "0"}
    opts.update(extra)
    for k, v in opts.items():
        P.param_parse(p, k, str(v))
    p.width, p.height = W, H
    return p


def _encode(preset, frames, attrs=(), **extra):
    p = _params(TP, preset, **extra)
    for k, v in attrs:
        setattr(p, k, v)
    enc = TEncoder(p, device="cpu")
    recons = []
    enc.recon_sink = lambda idx, planes: recons.append(planes)
    return enc, enc.encode(frames), recons


def _assert_decodes_to_recon(stream, recons, n):
    pics = HEVCDecoder().decode(stream)
    assert len(pics) == n == len(recons)
    for pic, rec in zip(pics, recons):
        for a, b in zip((pic.y, pic.cb, pic.cr), rec):
            assert np.array_equal(np.asarray(a), np.asarray(b))


def test_fast_zerolatency_non_aligned_byte_identical():
    frames = make_ramp_clip(W, H, 5, seed=1)
    enc, stream, recons = _encode("fast", frames)
    ref = JEncoder(_params(JP, "fast")).encode(frames)
    assert stream == ref
    assert "".join(s["type"] for s in enc.frame_stats) == "IPPPP"
    assert enc._last_weights[0] is not None
    assert (enc._last_sao.type_y != 0).any()
    assert (enc._last_analysis.qp_map != 30).any()
    _assert_decodes_to_recon(stream, recons, len(frames))


@pytest.mark.parametrize("preset", ["superfast", "veryfast", "faster"])
def test_presets_between_decode_to_recon(preset):
    """They differ from the two tested against the JAX package only in
    ctu, refs, sub_me and early_skip; here: accepted, and the stream
    decodes to the encoder's recon."""
    frames = make_ramp_clip(W, H, 4, seed=2)
    enc, stream, recons = _encode(preset, frames)
    assert "".join(s["type"] for s in enc.frame_stats) == "IPPP"
    _assert_decodes_to_recon(stream, recons, len(frames))


def test_sao_without_deblock_and_deblock_without_sao():
    """Each filter alone, and non-zero deblock offsets in the PPS."""
    frames = make_ramp_clip(W, H, 3, seed=3)
    offsets = (("deblock_beta_offset", 1), ("deblock_tc_offset", -1))
    for extra, attrs in (({"no-deblock": 1}, ()), ({"no-sao": 1}, ()),
                         ({}, offsets)):
        enc, stream, recons = _encode("fast", frames, attrs, **extra)
        _assert_decodes_to_recon(stream, recons, len(frames))
