"""`--open-gop 0` (x265's closed GOP): a scene cut gives an IDR, not a
CRA with RASL leading pictures (x265_tpu/api/encoder.py:475; the port's
branch in Encoder.encode_frame). The golden case `medium_crf_cut`'s clip
and options (medium, CRF 28, b-adapt 2, a cut at frame 7) with open-gop
off: the port's stream equals the JAX package's byte for byte and decodes
in the port's decoder to the encoder's recon."""
from x265_tpu.api import params as JP
from x265_tpu.api.encoder import Encoder as JEncoder
from x265_tpu_torch.api import params as TP
from x265_tpu_torch.api.encoder import Encoder as TEncoder
from x265_tpu_torch.hevc.bitstream import (NAL_CRA, NAL_IDR_W_RADL,
                                           NAL_RASL_N, split_annexb)
from x265_tpu_torch.utils import testclip
from torch_port_util import assert_decodes_to_recon, recon_collector


def _encoder(E, P, **kw):
    p = testclip.golden_params("medium_crf_cut", P)
    P.param_parse(p, "open-gop", "0")
    assert not p.open_gop
    return E(p, **kw)


def test_scenecut_closed_gop_gives_an_idr():
    frames = testclip.golden_clip("medium_crf_cut")
    enc = _encoder(TEncoder, TP, device="cpu")
    recons = recon_collector(enc)
    jenc = _encoder(JEncoder, JP)
    got, _q = testclip.golden_stream(enc, "medium_crf_cut", frames)
    want, _jq = testclip.golden_stream(jenc, "medium_crf_cut", frames)
    assert got == want
    assert enc._scenecut_frames == jenc._scenecut_frames == {7}
    nal = [(n[0] >> 1) & 0x3F for n in split_annexb(got)]
    vcl = [t for t in nal if t < 32]
    assert vcl.count(NAL_IDR_W_RADL) == 2           # the start and the cut
    assert NAL_CRA not in vcl and NAL_RASL_N not in vcl
    types = "".join(s["type"] for s in enc.frame_stats)
    assert types == "".join(s["type"] for s in jenc.frame_stats)
    assert types.count("I") == 2
    # the cut restarts the POCs: the IDR is POC 0 again
    pocs = [s["poc"] for s in enc.frame_stats]
    assert pocs.count(0) == 2
    assert_decodes_to_recon(got, recons(), len(frames))
