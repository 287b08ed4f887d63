"""The API calls a B-frame encode makes live, port against the JAX
package: reconfigure(bframes=...) mid-stream, and after every picture
get_ref_frame_list() (with a live pyramid B) and
get_slicetype_poc_and_scenecut()."""
from x265_tpu.api import params as JP
from x265_tpu.api.encoder import Encoder as JEncoder
from x265_tpu_torch.api import params as TP
from x265_tpu_torch.api.encoder import Encoder as TEncoder
from x265_tpu_torch.utils.testclip import make_clip
from torch_port_util import assert_decodes_to_recon, recon_collector


def _params(P, preset, w, h, **opts):
    p = P.param_default_preset(preset)
    for k, v in opts.items():
        P.param_parse(p, k.replace("_", "-"), str(v))
    p.width, p.height = w, h
    return p


def test_reconfigure_bframes_and_ref_frame_list():
    """fast under CRF with mini-GOPs of four (the pyramid's referenced B
    is live), then bframes 2 from the seventh picture on; after every
    picture the reference lists and the last output picture agree."""
    w, h = 192, 128
    frames = make_clip(w, h, 13, seed=5)
    enc = TEncoder(_params(TP, "fast", w, h, crf=28), device="cpu")
    recons = recon_collector(enc)
    jenc = JEncoder(_params(JP, "fast", w, h, crf=28))
    stream, ref = enc.headers(), jenc.headers()
    saw_l1 = False
    for i, f in enumerate(frames):
        if i == 6:
            enc.reconfigure(bframes=2)
            jenc.reconfigure(bframes=2)
        stream += enc.encode_frame(*f)
        ref += jenc.encode_frame(*f)
        assert stream == ref
        assert enc.get_ref_frame_list() == jenc.get_ref_frame_list()
        assert (enc.get_slicetype_poc_and_scenecut()
                == jenc.get_slicetype_poc_and_scenecut())
        saw_l1 |= bool(enc.get_ref_frame_list()["l1"])
    stream += enc.flush()
    ref += jenc.flush()
    assert stream == ref
    assert saw_l1 and enc.bframes == jenc.bframes == 2
    types = "".join(s["type"] for s in enc.frame_stats)
    assert types == "".join(s["type"] for s in jenc.frame_stats)
    assert "PBBBB" in types and "PBB" in types[6:]
    assert_decodes_to_recon(stream, recons(), len(frames))
