"""BASELINE config 4 at 192x128: golden case `main10_slow_hdr10` (x265's
slow preset at output-depth 10 with the default scaling lists, --hdr10,
--hdr10-opt, --master-display, --max-cll 1000,400, --dhdr10-info with
--dhdr10-opt, CRF 28, 11 frames). The port's stream and QPs equal the
JAX package's byte for byte (its committed golden record); the SPS says
Main10 with scaling lists, the first access unit carries the
mastering-display and content-light SEIs, each picture the HDR10+ SEI
--dhdr10-opt dictates, and the stream decodes in the port's decoder to
the encoder's recon."""
import struct

from x265_tpu_torch.engine import me as tme
from x265_tpu_torch.hevc.sei import (SEI_CONTENT_LIGHT_LEVEL,
                                     SEI_MASTERING_DISPLAY)
from x265_tpu_torch.utils import testclip
from torch_port_util import assert_decodes_to_recon, golden_encoders


def test_main10_slow_hdr10_golden(monkeypatch, tmp_path):
    ranges = set()
    int_stage = tme._int_stage

    def int_stage_rec(cur, ref_R, mvcost, S, R):
        ranges.add((S, R))
        return int_stage(cur, ref_R, mvcost, S, R)
    monkeypatch.setattr(tme, "_int_stage", int_stage_rec)
    enc, stream, recons, gold, frames = golden_encoders(
        "main10_slow_hdr10", str(tmp_path))
    p = enc.param
    assert (p.bit_depth == 10 and p.scaling_lists == "default" and p.hdr10
            and p.hdr10_opt and p.dhdr10_opt and p.rd_level == 4
            and p.rdoq_level == 2 and p.tu_inter_depth == 2)
    assert ranges == {(16, 57)}               # the dense search only
    qps = [s["qp"] for s in enc.frame_stats]
    assert qps == gold["qps"]
    sps, first, lums = testclip.stream_hdr10(stream)
    assert sps.bit_depth == 10 and sps.ptl.profile_idc == 2
    assert sps.scaling_list_enabled and sps.scaling_list_data is None
    assert (sps.colour_primaries, sps.transfer_characteristics,
            sps.matrix_coeffs) == (9, 16, 9)
    assert struct.unpack(">6H2H2I", first[SEI_MASTERING_DISPLAY]) == (
        13250, 34500, 7500, 3000, 34000, 16000, 15635, 16450, 10000000, 1)
    assert struct.unpack(">2H", first[SEI_CONTENT_LIGHT_LEVEL]) == (1000,
                                                                    400)
    types = [s["type"] for s in enc.frame_stats]
    pocs = [s["poc"] for s in enc.frame_stats]
    assert types.count("I") == 1 and pocs[0] == 0
    want = testclip.dhdr10_expected(types, pocs, len(frames))
    assert lums == want
    assert None in want and sum(v is not None for v in want) > 1
    assert_decodes_to_recon(stream, recons, len(frames))
