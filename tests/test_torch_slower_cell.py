"""The benchmark cell slower_1080p.crowd's configuration and what it makes
the port measure: the file parses through encbench.spec to x265's
slower as the port runs it; golden case `slower_abr` (utils/testclip.
GOLDEN_CASES, 192x128, 18 frames: the cell's options at its bitrate
scaled by the area, b-adapt 2) equals the JAX package's committed
record, decodes to its recon, and opens the RQT, RDOQ and dense-search
scopes with their counters and the slice-type decision's; the cell's
reader rqt_ms_per_frame reads its stage."""
import pytest

from encbench import spec
from torch_port_util import assert_decodes_to_recon, golden_encoders
from x265_tpu_torch.api.params import check_params
from x265_tpu_torch.utils import profiling

SCOPES = ("rqt", "rdoq", "me.dense")


def test_config_parses_to_the_stated_param():
    cfg = spec._load("configs", "slower_1080p")
    # the Encoder applies check_params (rc-lookahead's clamp to 32)
    p = check_params(spec.params(cfg))
    assert cfg["preset"] == "slower" and cfg["tune"] is None
    assert (p.bframes, p.ref, p.tu_inter_depth, p.rd_level, p.sub_me,
            p.max_merge, p.psy_rdoq, p.rc_lookahead) == \
        (8, 4, 2, 6, 4, 4, 1.0, 32)
    assert (p.width, p.height, p.fps_num, p.bitrate) == \
        (1920, 1080, 25, 4000)
    assert sorted(cfg["reduced"]) == ["rc-lookahead", "ref"]


def test_slower_abr_golden_scopes_and_counters():
    profiling.reset()
    profiling.record(True)
    try:
        enc, stream, recons, _gold, frames = golden_encoders("slower_abr")
        opened = {s.name for s in profiling.spans()}
        counters = profiling.counters()
    finally:
        profiling.record(False)
        profiling.reset()
    p = enc.param
    assert (p.bframes, p.b_adapt, p.ref, p.tu_inter_depth, p.sub_me,
            p.max_merge) == (8, 2, 4, 2, 4, 4)
    assert set(SCOPES) <= opened
    assert 0 < counters["rqt.tried"] and \
        counters["rqt.won"] <= counters["rqt.tried"]
    assert counters["rdoq.tbs"] > 0
    # one mini-GOP an anchor: every picture but the IDR is an anchor or
    # one of its B pictures, at most 8 of them
    n = counters["slicetype.minigops"]
    assert 0 < counters["slicetype.bframes"] <= 8 * n
    assert n + counters["slicetype.bframes"] == len(frames) - 1
    assert_decodes_to_recon(stream, recons, len(frames))


def _record():
    return {"pictures": 40, "stages": {"rqt": 2.0, "rdoq": 1.0}}


def test_rqt_reader_reads_its_stage():
    read = spec.reader("rqt_ms_per_frame")
    assert read(_record()) == pytest.approx(50.0)
    rec = _record()
    del rec["stages"]["rqt"]
    assert read(rec) is None
    assert read({"pictures": 0, "stages": {"rqt": 1.0}}) is None
