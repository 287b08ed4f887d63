"""`medium` without a tune at 200x120, port against the JAX package on
the same clip: partial CTUs, a lowres plane padded from 60 to 64 rows, a
scene cut, B frames placed by b-adapt 2 under rd 3. The streams are equal
byte for byte and the port's decodes to its recon."""
from x265_tpu.api import params as JP
from x265_tpu.api.encoder import Encoder as JEncoder
from x265_tpu_torch.api import params as TP
from x265_tpu_torch.api.encoder import Encoder as TEncoder
from x265_tpu_torch.utils.testclip import make_cut_clip
from torch_port_util import assert_decodes_to_recon, recon_collector


def _params(P, preset, w, h, **opts):
    p = P.param_default_preset(preset)
    for k, v in opts.items():
        P.param_parse(p, k.replace("_", "-"), str(v))
    p.width, p.height = w, h
    return p


def test_medium_non_aligned_size_byte_identical():
    w, h = 200, 120
    frames = make_cut_clip(w, h, 9, seed=12, cut=6)
    enc = TEncoder(_params(TP, "medium", w, h, crf=27), device="cpu")
    recons = recon_collector(enc)
    stream = enc.encode(frames)
    jenc = JEncoder(_params(JP, "medium", w, h, crf=27))
    assert stream == jenc.encode(frames)
    types = "".join(s["type"] for s in enc.frame_stats)
    assert types == "".join(s["type"] for s in jenc.frame_stats)
    assert types.count("B") >= 3
    assert_decodes_to_recon(stream, recons(), len(frames))
