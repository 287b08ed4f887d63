"""The live slice as a whole at 192x128 (utils/testclip.GOLDEN_CASES):
medium + zerolatency under CRF on a clip with a scene cut (the lookahead,
scenecut, cuTree, rd 3: RD merge adoption, 32/64 promotion and intra 32
promotion), the same without AQ (cu_qp_delta on through cuTree alone),
and fast + zerolatency under ABR with a VBV buffer small enough that
pictures are encoded again. The port's stream equals the JAX package's
byte for byte and decodes in the port's decoder to the encoder's recon;
the JAX package's stream is held against the committed golden digest."""
import pytest

from x265_tpu_torch.utils import profiling, testclip
from torch_port_util import assert_decodes_to_recon, golden_encoders


@pytest.mark.parametrize("name", ["medium_zerolatency_crf",
                                  "medium_zerolatency_crf_aq0"])
def test_crf_scenecut_stream_byte_identical(name):
    profiling.reset()
    enc, stream, recons, jenc, ref, frames = golden_encoders(name)
    assert stream == ref
    p = enc.param
    assert (p.rd_level == 3 and p.cu_tree and p.scenecut == 40
            and p.ref == 3 and p.bframes == 0 and not p.fast_intra)
    # the JAX side flagged the cut, and coded it as a CRA (open GOP)
    cut = testclip.GOLDEN_CUT
    assert jenc._scenecut_frames == enc._scenecut_frames == {cut}
    types = "".join(s["type"] for s in enc.frame_stats)
    assert types == "".join(s["type"] for s in jenc.frame_stats) == "IPPIP"
    assert enc.frame_stats[cut]["poc"] == cut        # a CRA keeps the POC
    assert enc.get_slicetype_poc_and_scenecut() == {
        "slice_type": "P", "poc": 4, "scenecut": False}
    qmap = enc._last_analysis.qp_map
    assert qmap is not None
    if name.endswith("aq0"):
        assert (qmap == enc.frame_stats[-1]["qp"]).all()
    # the port went through the lookahead and both RD passes
    stages = profiling.report()
    for st in ("lookahead", "rd_adopt", "rd_promote"):
        assert stages[st]["calls"] >= 1, st
    assert_decodes_to_recon(stream, recons, len(frames))


def test_abr_vbv_reencodes_byte_identical():
    enc, stream, recons, jenc, ref, frames = golden_encoders(
        "fast_zerolatency_abr_vbv")
    assert stream == ref
    assert jenc.vbv_reencodes >= 1
    assert enc.vbv_reencodes == jenc.vbv_reencodes
    assert [s["qp"] for s in enc.frame_stats] == \
        [s["qp"] for s in jenc.frame_stats]
    assert len(set(s["qp"] for s in enc.frame_stats)) > 2
    assert len(enc.frame_stats) == len(frames)
    assert_decodes_to_recon(stream, recons, len(frames))
