"""The B-frame golden case `medium_abr` (utils/testclip.GOLDEN_CASES,
192x128, 11 frames): bench.py config 3's settings — `medium` without a
tune under ABR — at 100 kbps. The port's stream and QPs equal the JAX
package's (the JAX stream held against the committed golden digest) and
the stream decodes in the port's decoder to the encoder's recon."""
from torch_port_util import assert_decodes_to_recon, golden_encoders


def test_medium_abr_config3_scaled():
    """bench.py config 3's settings (medium, no tune, ABR) at 100 kbps:
    the B pictures' rate-control ends lag their starts by the pipeline
    depth (frame-threads 2), so every QP must follow the reference's."""
    enc, stream, recons, jenc, ref, frames = golden_encoders("medium_abr")
    assert stream == ref
    assert enc.param.frame_parallelism == 2 and enc.param.bitrate == 100
    qps = [s["qp"] for s in enc.frame_stats]
    assert qps == [s["qp"] for s in jenc.frame_stats]
    assert len(set(qps)) > 3
    types = "".join(s["type"] for s in enc.frame_stats)
    assert types.count("B") >= 4 and types[0] == "I"
    assert_decodes_to_recon(stream, recons, len(frames))
