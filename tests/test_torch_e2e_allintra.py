"""All-intra (keyint 1) and lossless: the golden cases
`ultrafast_lossless_allintra` (bench.py config 1's options) and
`medium_allintra_crf` (rd 3's intra 32x32 promotion inside the pipeline)
through Encoder.encode's pipelined path, their encode_frame streams, a
clip long enough for three chunks, and `fast_lossless` (P and B pictures
under transquant bypass). The port's streams equal the JAX package's
byte for byte; a lossless stream decodes in the port's decoder to the
source itself."""
import numpy as np
import pytest

from x265_tpu.api import params as JP
from x265_tpu.api.encoder import Encoder as JEncoder
from x265_tpu_torch.api import params as TP
from x265_tpu_torch.api.encoder import Encoder as TEncoder
from x265_tpu_torch.decoder.decoder import HEVCDecoder
from x265_tpu_torch.utils import profiling, testclip
from torch_port_util import (assert_decodes_to_recon, golden_encoders,
                             recon_collector)


def assert_decodes_to_source(stream, frames):
    pics = HEVCDecoder().decode(stream)
    assert len(pics) == len(frames)
    for pic, src in zip(pics, frames):
        for a, b in zip((pic.y, pic.cb, pic.cr), src):
            assert np.array_equal(np.asarray(a), np.asarray(b))


def test_lossless_allintra_pipelined():
    """bench.py config 1 (ultrafast, lossless, keyint 1) at 192x128:
    every picture an IDR, transquant bypass signalled, no SAO, no deblock,
    no cu_qp_delta, sign hiding off; the decoded planes are the source."""
    profiling.reset()
    enc, stream, recons, gold, frames = golden_encoders(
        "ultrafast_lossless_allintra")
    assert "".join(s["type"] for s in enc.frame_stats) == "IIIII"
    assert [s["poc"] for s in enc.frame_stats] == [0] * 5
    assert enc.pps.transquant_bypass_enabled
    assert not enc.pps.sign_data_hiding
    assert not enc.pps.cu_qp_delta_enabled
    assert enc.sps.max_dec_pic_buffering == 1
    assert profiling.report()["analysis"]["calls"] >= 1
    assert_decodes_to_source(stream, frames)
    for rec, src in zip(recons, frames):
        for a, b in zip(rec, src):
            assert np.array_equal(np.asarray(a), np.asarray(b))


def test_crf_allintra_pipelined_promotes_32x32():
    """medium + CRF 28 with keyint 1: rate control starts every picture
    from the analysis's summed intra cost, and rd 3 promotes 16x16 groups
    to 32x32 intra CUs inside the pipelined loop."""
    profiling.reset()
    enc, stream, recons, gold, frames = golden_encoders(
        "medium_allintra_crf")
    qps = [s["qp"] for s in enc.frame_stats]
    assert qps == gold["qps"]
    assert (enc._last_analysis.cu_log2_map == 5).any()
    assert profiling.report()["rd_promote"]["calls"] == len(frames)
    assert_decodes_to_recon(stream, recons, len(frames))


@pytest.mark.parametrize("name", ["ultrafast_lossless_allintra",
                                  "medium_allintra_crf"])
def test_encode_frame_keyint1_equals_reference(name):
    """The CLI's entry point (encode_frame per picture) with keyint 1: the
    same stream as the JAX package's encode_frame."""
    frames = testclip.golden_clip(name)
    streams = []
    for P, E, kw in ((TP, TEncoder, {"device": "cpu"}), (JP, JEncoder, {})):
        enc = E(testclip.golden_params(name, P), **kw)
        s = enc.headers()
        for f in frames:
            s += enc.encode_frame(*f)
        streams.append(s + enc.flush())
    assert streams[0] == streams[1]
    if name == "ultrafast_lossless_allintra":
        assert_decodes_to_source(streams[0], frames)


def test_pipelined_chunks_and_inflight_queue(monkeypatch):
    """17 frames at 64x64: three chunks of the analysis (8, 8, 1), two
    enqueued ahead of the writer; the stream equals the reference's and
    decodes to the source."""
    from x265_tpu_torch.models import intra_frame
    events = []
    submit, finish = (intra_frame.submit_intra_analysis_batch,
                      intra_frame.finish_intra_analysis)

    def submit_rec(srcs, *a, **kw):
        events.append(len(srcs))
        return submit(srcs, *a, **kw)

    def finish_rec(h):
        events.append("f")
        return finish(h)
    monkeypatch.setattr(intra_frame, "submit_intra_analysis_batch",
                        submit_rec)
    monkeypatch.setattr(intra_frame, "finish_intra_analysis", finish_rec)
    frames = testclip.make_clip(64, 64, 17, seed=9)
    streams = []
    for P, E, kw in ((TP, TEncoder, {"device": "cpu"}), (JP, JEncoder, {})):
        p = P.param_default_preset("ultrafast")
        P.param_parse(p, "lossless")
        P.param_parse(p, "keyint", "1")
        p.width, p.height = 64, 64
        enc = E(p, **kw)
        if E is TEncoder:
            got = recon_collector(enc)
        streams.append(enc.encode(frames))
    assert streams[0] == streams[1]
    assert len(got()) == 17
    assert events == [8, 8] + ["f"] * 8 + [1] + ["f"] * 9
    assert_decodes_to_source(streams[0], frames)


def test_lossless_with_p_and_b_pictures():
    """fast + lossless: P and B pictures whose inter residual runs on the
    device under transquant bypass; the decoded planes are the source."""
    enc, stream, recons, gold, frames = golden_encoders("fast_lossless")
    types = "".join(s["type"] for s in enc.frame_stats)
    assert "P" in types and "B" in types
    assert enc._last_analysis.inter8.any()
    assert enc.pps.transquant_bypass_enabled
    assert not enc.pps.cu_qp_delta_enabled and enc._last_sao is None
    assert_decodes_to_source(stream, frames)
