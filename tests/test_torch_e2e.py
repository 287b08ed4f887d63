"""The first slice as a whole: the port's Encoder against the JAX package's,
in the slice's configuration (ultrafast + zerolatency, qp 30, scenecut 0,
ref 1). Streams are compared byte for byte, the port's stream is decoded by
the port's decoder back to the encoder's recon, and the JAX package's stream
is held against the committed golden digest
(x265_tpu_torch/utils/golden_streams.json), which a machine without JAX
compares its own stream with. The filtered slice (fast + zerolatency) at the
same size is in tests/test_torch_e2e_golden.py, at 200x120 in
tests/test_torch_e2e_filtered.py: files of their own, so that other workers
take the JAX package's compiles for those configurations."""
import numpy as np
import pytest

from x265_tpu.api.encoder import Encoder as JEncoder
from x265_tpu_torch.api.encoder import Encoder as TEncoder
from x265_tpu_torch.decoder.decoder import HEVCDecoder
from torch_port_util import (
    golden_pair, make_clip, make_hard_clip, slice_params)


def _encode_torch(frames, w, h, **extra):
    enc = TEncoder(slice_params("x265_tpu_torch", w, h, **extra),
                   device="cpu")
    recons = []
    enc.recon_sink = lambda idx, planes: recons.append(planes)
    return enc, enc.encode(frames), recons


def test_stream_byte_identical_and_decodes_to_recon():
    enc, stream, recons, ref, frames = golden_pair("ultrafast_zerolatency")
    assert stream == ref
    assert "".join(s["type"] for s in enc.frame_stats) == "IPPPP"
    assert enc._last_analysis.inter8.any() and np.any(
        enc._last_analysis.mv8)
    pics = HEVCDecoder().decode(stream)
    assert len(pics) == len(frames) == len(recons)
    for pic, rec in zip(pics, recons):
        for a, b in zip((pic.y, pic.cb, pic.cr), rec):
            assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("w,h,qp,ctu", [(192, 128, 30, 32),
                                        (256, 128, 36, 64)])
def test_threshold_content_byte_identical(w, h, qp, ctu):
    """Content built so that every thresholded decision falls on both
    sides: a mix of intra and inter CUs, of 8/16/32/64 CUs, of coded and
    skipped residuals."""
    frames = make_hard_clip(w, h, 4, seed=qp)
    extra = dict(qp=qp, ctu=ctu)
    enc, stream, recons = _encode_torch(frames, w, h, **extra)
    ref = JEncoder(slice_params("x265_tpu", w, h, **extra)).encode(frames)
    assert stream == ref
    dec = enc._last_analysis
    assert len(np.unique(dec.cu_log2_map)) >= 2
    assert len(np.unique(dec.mv8.reshape(-1, 4), axis=0)) > 3
    pics = HEVCDecoder().decode(stream)
    for pic, rec in zip(pics, recons):
        for a, b in zip((pic.y, pic.cb, pic.cr), rec):
            assert np.array_equal(np.asarray(a), np.asarray(b))


def test_non_aligned_size_two_refs_keyint():
    """A size that is no multiple of the CTU or of 16, two references,
    and a keyframe inside the clip (open GOP: a CRA)."""
    w, h = 200, 120
    frames = make_clip(w, h, 5, seed=2, step=(1, 4))
    extra = dict(ref=2, keyint=3)
    enc, stream, recons = _encode_torch(frames, w, h, **extra)
    ref = JEncoder(slice_params("x265_tpu", w, h, **extra)).encode(frames)
    assert stream == ref
    assert "".join(s["type"] for s in enc.frame_stats) == "IPPIP"
    pics = HEVCDecoder().decode(stream)
    assert len(pics) == len(frames)
    for pic, rec in zip(pics, recons):
        assert np.array_equal(np.asarray(pic.y), np.asarray(rec[0]))


def test_frame_by_frame_api_and_headers():
    w, h = 64, 64
    frames = make_clip(w, h, 3, seed=5)
    enc = TEncoder(slice_params("x265_tpu_torch", w, h), device="cpu")
    jenc = JEncoder(slice_params("x265_tpu", w, h))
    assert enc.headers() == jenc.headers()
    for i, f in enumerate(frames):
        assert enc.encode_frame(*f) == jenc.encode_frame(*f)
        if i == 0:
            # a plain host picture is accepted as a reference too
            host = tuple(np.array(pl) for pl in enc._last_recon.host())
            enc.anchor = (0, host)
            enc.anchors = [enc.anchor]
    assert enc.flush() == jenc.flush() == b""
    st = enc.get_stats()
    assert st["frames"] == 3 and st["by_type"]["P"]["count"] == 2


def test_cli_writes_the_same_stream(tmp_path):
    from x265_tpu_torch.cli import main
    from x265_tpu_torch.io.y4m import VideoInfo, write_y4m
    w, h = 64, 64
    frames = make_clip(w, h, 3, seed=6)
    src = tmp_path / "in.y4m"
    out = tmp_path / "out.hevc"
    write_y4m(str(src), frames, VideoInfo(width=w, height=h, fps_num=25,
                                          fps_den=1, bit_depth=8))
    assert main(["--input", str(src), "--output", str(out), "--preset",
                 "ultrafast", "--tune", "zerolatency", "--qp", "30",
                 "--scenecut", "0", "--ref", "1", "--device", "cpu"]) == 0
    p = slice_params("x265_tpu_torch", w, h)
    p.psnr_metrics = True
    want = TEncoder(p, device="cpu").encode(frames)
    assert out.read_bytes() == want
