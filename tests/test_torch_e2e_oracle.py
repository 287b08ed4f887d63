"""The Python oracle writer (Encoder.use_native = False) and the native
walk's own quantization (use_tpu_residual = False) at 192x128
(utils/testclip.GOLDEN_CASES, GOLDEN_ATTRS), each equal to the JAX
package's stream (its committed golden record) and decoded back to the
recon; and
PART_NxN intra CUs, which only the Python writer codes, through
headers + encode_frame + flush in both packages."""
import hashlib

import numpy as np
import pytest

from torch_port_util import (assert_decodes_to_recon, golden_encoders,
                             recon_collector)
from x265_tpu_torch.utils import testclip


def _no_native(monkeypatch):
    from x265_tpu_torch import native

    def never(*a, **kw):
        raise AssertionError("the native writer ran")
    monkeypatch.setattr(native, "encode_slice_px", never)


def test_python_writer_low_latency_golden(monkeypatch):
    _no_native(monkeypatch)
    enc, stream, recons, gold, frames = golden_encoders(
        "ultrafast_zerolatency_py")
    assert not enc.use_native
    assert not enc.param.deblock and not enc.param.sao
    assert_decodes_to_recon(stream, recons, len(frames))


def test_python_writer_sao_rdoq_golden(monkeypatch):
    _no_native(monkeypatch)
    enc, stream, recons, gold, frames = golden_encoders(
        "fast_zerolatency_rdoq_py")
    p = enc.param
    assert p.rdoq_level == 2 and p.sao and p.deblock and p.weightp
    sp = enc._last_sao
    assert (sp.type_y != 0).any() or (sp.type_c != 0).any()
    assert_decodes_to_recon(stream, recons, len(frames))


def test_cpu_residual_golden_equals_config3_stream(monkeypatch):
    """config 3's options (medium ABR) with every TB quantized by the
    native walk: no device residual runs, and the stream is
    medium_abr's, byte for byte."""
    from x265_tpu_torch.models import inter_residual

    def never(*a, **kw):
        raise AssertionError("the device residual ran")
    monkeypatch.setattr(inter_residual, "build_inter_pre", never)
    enc, stream, recons, gold, frames = golden_encoders(
        "medium_abr_cpu_residual")
    gold = testclip.golden_digests()
    assert (gold["medium_abr_cpu_residual"]["sha256"]
            == gold["medium_abr"]["sha256"]
            == hashlib.sha256(stream).hexdigest())
    assert "B" in "".join(s["type"] for s in enc.frame_stats)
    assert_decodes_to_recon(stream, recons, len(frames))


def _nxn_frames(w, h, n, seed=7):
    """tests/test_decoder_x265_features.py's frames."""
    rng = np.random.default_rng(seed)
    out = []
    base = rng.integers(16, 235, (h + 32, w + 32), np.uint8)
    for i in range(n):
        y = base[i:i + h, 2 * i:2 * i + w].copy()
        y[h // 4:h // 2, w // 8:w // 2] = rng.integers(
            0, 255, (h // 2 - h // 4, w // 2 - w // 8), np.uint8)
        cb = ((np.mgrid[0:h // 2, 0:w // 2][1] + 3 * i) % 200
              + 20).astype(np.uint8)
        cr = np.full((h // 2, w // 2), 128, np.uint8)
        out.append((y, cb, cr))
    return out


def _nxn_stream(pkg):
    """The NxN oracle encode of tests/test_decoder_x265_features.py
    (every other 8x8 CU PART_NxN with varied per-PB modes, DM chroma),
    driven through headers + encode_frame + flush so that the patched
    _intra_decisions is reached (Encoder.encode's pipelined keyint-1 path
    hands its own decisions to the writer and never calls it)."""
    import importlib
    enc_mod = importlib.import_module(f"{pkg}.api.encoder")
    params = importlib.import_module(f"{pkg}.api.params")
    w, h = 96, 64
    p = params.param_default_preset("ultrafast")
    p.width, p.height = w, h
    p.qp, p.rc_mode = 30, params.RC_CQP
    p.keyint, p.bframes = 1, 0
    enc = (enc_mod.Encoder(p, device="cpu") if pkg == "x265_tpu_torch"
           else enc_mod.Encoder(p))
    enc.use_native = False
    orig = enc._intra_decisions
    calls = []

    def patched(y):
        dec = orig(y)
        dec.cu_log2_map[:] = 3
        h8, w8 = dec.cu_log2_map.shape
        dec.nxn8 = (np.indices((h8, w8)).sum(0) % 2 == 0)
        m4 = np.repeat(np.repeat(dec.luma_mode8, 2, 0), 2, 1)
        m4[::2, 1::2] = (m4[::2, 1::2] + 7) % 35
        m4[1::2, ::2] = (m4[1::2, ::2] + 19) % 35
        dec.luma_mode4 = m4
        dec.chroma_mode8 = None
        calls.append(1)
        return dec
    enc._intra_decisions = patched
    recons = recon_collector(enc) if pkg == "x265_tpu_torch" else None
    frames = _nxn_frames(w, h, 2)
    stream = enc.headers()
    for f in frames:
        stream += enc.encode_frame(*f)
    stream += enc.flush()
    assert len(calls) == 2
    return stream, recons() if recons else None


def test_nxn_oracle_stream():
    from x265_tpu_torch.decoder import de265
    from x265_tpu_torch.decoder.decoder import HEVCDecoder
    stream, recons = _nxn_stream("x265_tpu_torch")
    ref, _ = _nxn_stream("x265_tpu")
    assert stream == ref
    dec = HEVCDecoder(collect_stats=True)
    pics = dec.decode(stream)
    assert len(pics) == 2
    kinds = [k for _poc, _t, ev in dec.pic_stats for (_s, _z, k, *_r) in ev]
    # every other 8x8 CU of the 96x64 pictures: 48 a picture
    assert kinds.count("intra_nxn") == 2 * 48
    for pic, rec in zip(pics, recons):
        for a, b in zip((pic.y, pic.cb, pic.cr), rec):
            assert np.array_equal(np.asarray(a), np.asarray(b))
    if not de265.available():
        pytest.skip("libde265 is not installed")
    ext = de265.decode(stream)
    assert len(ext) == 2
    for pic, e in zip(pics, ext):
        for a, b in zip((pic.y, pic.cb, pic.cr), e):
            assert np.array_equal(a, np.asarray(b).astype(np.int32))
