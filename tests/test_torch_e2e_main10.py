"""Main10 (output-depth 10) golden cases (utils/testclip.GOLDEN_CASES,
192x128, clips lifted to 10 bits by testclip.lift10):
`main10_fast_zerolatency` (weightp, deblock and SAO at 10 bits on the
low-latency path), `main10_medium_scaling` (B frames, the hierarchical
search with its window entry, the default scaling lists) and
`main10_lossless_allintra` (the pipelined all-intra path). The port's
streams and QPs equal the JAX package's byte for byte (the JAX stream held
against the committed golden digest); each decodes in the port's decoder
to the encoder's recon, and the lossless one to the source."""
import numpy as np

from x265_tpu_torch.engine import me as tme
from torch_port_util import assert_decodes_to_recon, golden_encoders


def _main10_sps(enc, scaling):
    assert enc.param.bit_depth == 10
    assert enc.sps.bit_depth == 10
    assert enc.sps.ptl.profile_idc == 2              # Main10
    assert enc.sps.scaling_list_enabled == scaling
    assert enc.sps.scaling_list_data is None         # default lists


def test_main10_fast_zerolatency_weightp_deblock_sao():
    enc, stream, recons, jenc, ref, frames = golden_encoders(
        "main10_fast_zerolatency")
    assert stream == ref
    assert frames[0][0].dtype == np.uint16 and frames[0][0].max() > 255
    _main10_sps(enc, False)
    p = enc.param
    assert p.deblock and p.sao and p.weightp
    assert "".join(s["type"] for s in enc.frame_stats) == "IPPPP"
    assert enc._last_weights[0] is not None          # the ramp was found
    sp = enc._last_sao
    assert (sp.type_y != 0).any() or (sp.type_c != 0).any()
    assert recons[0][0].max() > 255                  # 10-bit recon
    assert_decodes_to_recon(stream, recons, len(frames))


def test_main10_medium_scaling_bframes_hme(monkeypatch):
    calls = {"local": 0, "int": set()}
    local, int_stage = tme._local_search, tme._int_stage

    def local_rec(*a, **kw):
        calls["local"] += 1
        return local(*a, **kw)

    def int_rec(cur, ref_R, mvcost, S, R):
        calls["int"].add((S, R))
        return int_stage(cur, ref_R, mvcost, S, R)
    monkeypatch.setattr(tme, "_local_search", local_rec)
    monkeypatch.setattr(tme, "_int_stage", int_rec)
    enc, stream, recons, jenc, ref, frames = golden_encoders(
        "main10_medium_scaling")
    assert stream == ref
    _main10_sps(enc, True)
    qps = [s["qp"] for s in enc.frame_stats]
    assert qps == [s["qp"] for s in jenc.frame_stats]
    types = "".join(s["type"] for s in enc.frame_stats)
    assert types[0] == "I" and "P" in types and "B" in types
    # the hierarchical search: a coarse sweep and the +-7 window entry
    assert calls["local"] > 0 and calls["int"] and (16, 57) not in calls["int"]
    assert_decodes_to_recon(stream, recons, len(frames))


def test_main10_lossless_allintra_decodes_to_source():
    from test_torch_e2e_allintra import assert_decodes_to_source
    enc, stream, recons, jenc, ref, frames = golden_encoders(
        "main10_lossless_allintra")
    assert stream == ref
    _main10_sps(enc, False)                # lossless: no matrices
    assert enc.pps.transquant_bypass_enabled
    assert "".join(s["type"] for s in enc.frame_stats) == "IIIII"
    assert_decodes_to_source(stream, frames)
    for rec, src in zip(recons, frames):
        for a, b in zip(rec, src):
            assert np.array_equal(np.asarray(a), np.asarray(b))
