"""Stream structure and live robustness at 192x128
(utils/testclip.GOLDEN_CASES): the live encode with WPP substreams and the
intra-refresh column sweep, a dropped duplicate with a luma-histogram
scene cut, and WPP on the pipelined all-intra lossless path. The port's
stream equals the JAX package's byte for byte, the JAX package's stream
is held against the committed golden digest, and the port's decoder reads
each back to the encoder's recon (lossless: to the source)."""
import numpy as np

from x265_tpu_torch.utils import testclip
from torch_port_util import assert_decodes_to_recon, golden_encoders


def _refresh_spy(log):
    """Record, for each call of _apply_intra_refresh, the column it forced
    and the decisions after it."""
    def setup(enc):
        orig = enc._apply_intra_refresh

        def run(dec):
            col = enc._ir_col % enc.param.pic_width_in_ctbs
            orig(dec)
            log.append((col, dec.inter8.copy(), dec.cu_log2_map.copy()))
        enc._apply_intra_refresh = run
    return setup


def test_wpp_intra_refresh_live_golden():
    log = []
    enc, stream, recons, jenc, ref, frames = golden_encoders(
        "medium_zerolatency_wpp_ir", setup=_refresh_spy(log))
    assert stream == ref
    p = enc.param
    assert p.wpp and p.intra_refresh and p.rd_level == 3
    assert enc.pps.entropy_coding_sync_enabled
    pics = testclip.stream_structure(stream)
    assert "".join("IPB"[2 - x["slice_type"]] for x in pics) == "IPPIP"
    rows = p.pic_height_in_ctbs
    assert rows == 2
    # one slice a picture, an entry point per CTB row after the first
    assert all(x["slices"] == [(0, rows - 1)] for x in pics)
    # the refresh sweep: columns 0, 1 of the first two P pictures, column
    # 2 after the cut (the sweep goes on across the CRA); the cycle's
    # start carries the recovery point, ncols - 1 pictures ahead
    ncols = p.pic_width_in_ctbs
    assert [c for c, _, _ in log] == [0, 1, 2]
    assert [x["recovery"] for x in pics] == [None, ncols - 1, None, None,
                                             None]
    w8 = p.ctu_size >> 3
    for col, inter8, cu in log:
        assert not inter8[:, col * w8:(col + 1) * w8].any()
        assert (cu[:, col * w8:(col + 1) * w8] <= 5).all()
        assert inter8.any()                  # the rest stays inter
    assert enc._scenecut_frames == jenc._scenecut_frames == {
        testclip.GOLDEN_CUT}
    assert_decodes_to_recon(stream, recons, len(frames))


def test_frame_dup_hist_scenecut_golden():
    enc, stream, recons, jenc, ref, frames = golden_encoders(
        "medium_zerolatency_dup_hist")
    assert stream == ref
    dup, cut = testclip.GOLDEN_DUP, testclip.GOLDEN_FRAMES[
        "medium_zerolatency_dup_hist"][1]
    p = enc.param
    assert p.frame_dup and p.hist_scenecut and p.scenecut == 0
    assert enc.sps.frame_field_info
    # the duplicate is dropped: one picture fewer, its predecessor
    # signals frame doubling in its pic_timing SEI
    assert enc.frame_count == len(frames)
    assert len(enc.frame_stats) == len(frames) - 1
    pics = testclip.stream_structure(stream)
    ps = [x["pic_struct"] for x in pics]
    assert sorted(ps) == [0] * (len(pics) - 1) + [7]
    # the doubled picture is input dup - 1 (POC dup - 1 before the cut)
    assert enc.frame_stats[ps.index(7)]["poc"] == dup - 1 < cut
    # the histogram cut (the lookahead's scenecut is off) is the keyframe
    assert enc._scenecut_frames == jenc._scenecut_frames == {cut}
    assert [x["nal"] for x in pics].count(21) == 1            # a CRA
    # the queue one deeper under --frame-dup: zerolatency's pictures
    # leave in pairs, the first as a B picture (ROADMAP Queue 3)
    assert "".join(s["type"] for s in enc.frame_stats) == "IPBIPB"
    assert_decodes_to_recon(stream, recons, len(frames) - 1)


def test_wpp_lossless_allintra_golden():
    enc, stream, recons, jenc, ref, frames = golden_encoders(
        "ultrafast_lossless_wpp")
    assert stream == ref
    rows = enc.param.pic_height_in_ctbs
    assert rows == 4
    pics = testclip.stream_structure(stream)
    assert len(pics) == len(frames)
    assert all(x["nal"] == 19 and x["slices"] == [(0, rows - 1)]
               for x in pics)
    assert_decodes_to_recon(stream, recons, len(frames))
    for rec, f in zip(recons, frames):
        for a, b in zip(rec, f):
            assert np.array_equal(np.asarray(a), np.asarray(b))
