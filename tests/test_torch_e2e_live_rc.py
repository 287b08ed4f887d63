"""The live slice's rate control beyond the golden cases, port against
the JAX package on the same clips (192x128, 5 frames): a bitrate change
mid-stream through Encoder.reconfigure, and fast + zerolatency under CRF
(no rd 3: the SATD merge adoption and the host promotion rules, with the
lookahead and scenecut on)."""
import pytest

from x265_tpu.api import params as JP
from x265_tpu.api.encoder import Encoder as JEncoder
from x265_tpu_torch.api import params as TP
from x265_tpu_torch.api.encoder import Encoder as TEncoder
from x265_tpu_torch.utils.testclip import make_clip, make_cut_clip
from torch_port_util import assert_decodes_to_recon, recon_collector

W, H = 192, 128


def _params(P, preset, **opts):
    p = P.param_default_preset(preset, "zerolatency")
    for k, v in opts.items():
        P.param_parse(p, k.replace("_", "-"), str(v))
    p.width, p.height = W, H
    return p


def _encode(enc, frames, change_at=None, change=None):
    out = enc.headers()
    for i, f in enumerate(frames):
        if i == change_at:
            enc.reconfigure(**change)
        out += enc.encode_frame(*f)
    return out + enc.flush()


def test_reconfigure_bitrate_midstream():
    """ABR + VBV at 300 kbps, then 120 kbps with a smaller buffer from
    the third picture on: the rate control is rebuilt the same way."""
    frames = make_clip(W, H, 5, seed=2)
    opts = dict(bitrate=300, vbv_maxrate=300, vbv_bufsize=100)
    change = dict(bitrate=120, vbv_maxrate=120, vbv_bufsize=40)
    enc = TEncoder(_params(TP, "medium", **opts), device="cpu")
    recons = recon_collector(enc)
    jenc = JEncoder(_params(JP, "medium", **opts))
    stream = _encode(enc, frames, 2, change)
    assert stream == _encode(jenc, frames, 2, change)
    qps = [s["qp"] for s in enc.frame_stats]
    assert qps == [s["qp"] for s in jenc.frame_stats]
    assert enc.param.bitrate == 120 and enc.param.vbv_bufsize == 40
    assert_decodes_to_recon(stream, recons(), len(frames))
    enc.reconfigure(bframes=2)            # B frames are ported
    assert enc.bframes == 2
    with pytest.raises(ValueError):
        enc.reconfigure(ref=2)


def test_fast_zerolatency_crf_byte_identical():
    frames = make_cut_clip(W, H, 5, seed=6, cut=2)
    enc = TEncoder(_params(TP, "fast", crf=26), device="cpu")
    recons = recon_collector(enc)
    stream = enc.encode(frames)
    jenc = JEncoder(_params(JP, "fast", crf=26))
    assert stream == jenc.encode(frames)
    assert enc.param.rd_level == 2 and enc.param.cu_tree
    assert jenc._scenecut_frames == enc._scenecut_frames == {2}
    assert "".join(s["type"] for s in enc.frame_stats) == "IPIPP"
    assert_decodes_to_recon(stream, recons(), len(frames))


def test_medium_crf_non_aligned_size_byte_identical():
    """medium + zerolatency at 200x120 (no multiple of the CTU or of 16:
    partial CTUs, a lowres plane padded from 60 to 64 rows) with a cut at
    frame 3 and ABR + VBV."""
    w, h = 200, 120
    frames = make_cut_clip(w, h, 5, seed=8, cut=3)
    opts = dict(bitrate=250, vbv_maxrate=250, vbv_bufsize=120)

    def params(P):
        p = _params(P, "medium", **opts)
        p.width, p.height = w, h
        return p
    enc = TEncoder(params(TP), device="cpu")
    recons = recon_collector(enc)
    stream = enc.encode(frames)
    jenc = JEncoder(params(JP))
    assert stream == jenc.encode(frames)
    assert jenc._scenecut_frames == enc._scenecut_frames == {3}
    assert "".join(s["type"] for s in enc.frame_stats) == "IPPIP"
    assert_decodes_to_recon(stream, recons(), len(frames))
