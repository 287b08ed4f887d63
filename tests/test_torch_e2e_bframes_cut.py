"""The B-frame golden case `medium_crf_cut` (utils/testclip.GOLDEN_CASES,
192x128, 11 frames): `medium` without a tune under CRF on a clip with a
scene cut at frame 7 — b-adapt 2, rd 3, and a CRA whose queued pictures
become RASL leading pictures. The port's stream equals the JAX package's
byte for byte (its committed golden record)
and decodes in the port's decoder to the encoder's recon."""
from x265_tpu_torch.utils import profiling
from torch_port_util import assert_decodes_to_recon, golden_encoders


def test_medium_crf_cut_badapt_cra():
    """b-adapt 2 with rd 3; the cut at frame 7 fires (min-keyint is
    bframes + 1) while six pictures are queued: a CRA, then the six coded
    as RASL_N leading pictures between the old anchor and the CRA."""
    profiling.reset()
    enc, stream, recons, gold, frames = golden_encoders(
        "medium_crf_cut")
    p = enc.param
    assert p.b_adapt == 2 and p.rd_level == 3 and p.rc_lookahead == 20
    assert enc._scenecut_frames == set(gold["scenecut_frames"]) == {7}
    types = "".join(s["type"] for s in enc.frame_stats)
    assert types == gold["types"]
    assert types.startswith("II" + "B" * 6)
    assert [s["poc"] for s in enc.frame_stats][1] == 7
    from x265_tpu_torch.hevc.bitstream import NAL_RASL_N, split_annexb
    nal_types = [(n[0] >> 1) & 0x3F for n in split_annexb(stream)]
    assert nal_types.count(NAL_RASL_N) == 6
    stages = profiling.report()
    for st in ("lookahead", "slicetype", "rd_adopt", "rd_promote"):
        assert stages[st]["calls"] >= 1, st
    assert_decodes_to_recon(stream, recons, len(frames))
