"""HDR10 signalling and the depth tools of the port against the JAX
package: the HDR10+ SEI per picture and the --dhdr10-opt dedup (as
tests/test_apps_io.py holds the JAX package, with fixtures in tmp_path),
the mastering-display and content-light SEIs and the VUI colour
description (as tests/test_hdr10.py), the CLI on a 10-bit Y4M (Main10,
--output-depth 8 with and without --dither, a 10-bit --recon), and
dither_image. Streams are byte-identical to the JAX package's."""
import json
import struct

import numpy as np
import pytest

from x265_tpu.api import params as JP
from x265_tpu.api.encoder import Encoder as JEncoder
from x265_tpu_torch.api import params as TP
from x265_tpu_torch.api.encoder import Encoder as TEncoder
from x265_tpu_torch.hevc.sei import (SEI_CONTENT_LIGHT_LEVEL,
                                     SEI_MASTERING_DISPLAY)
from x265_tpu_torch.utils import testclip
import torch_port_util  # noqa: F401  (one torch thread)


def _small_frames(n, seed=7, h=64, w=96):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h, w)).astype(np.uint8)
    return [(np.roll(base, i * 2, axis=1),
             np.full((h // 2, w // 2), 120, np.uint8),
             np.full((h // 2, w // 2), 130, np.uint8)) for i in range(n)]


def _both(opts, frames, preset="ultrafast", **attrs):
    """The same options through both packages; (port stream, JAX
    stream, port encoder)."""
    out = []
    for P, E, kw in ((TP, TEncoder, {"device": "cpu"}), (JP, JEncoder, {})):
        p = P.param_default_preset(preset)
        p.width, p.height = 96, 64
        for k, v in attrs.items():
            setattr(p, k, v)
        for k, v in opts:
            P.param_parse(p, k, v)
        enc = E(p, **kw)
        out.append((enc.encode(frames), enc))
    return out[0][0], out[1][0], out[0][1]


def test_dhdr10_sei_per_picture(tmp_path):
    """One HDR10+ SEI per access unit, indexed by display order, with B
    frames reordering the pictures (tests/test_apps_io.py:72)."""
    n = 4
    scenes = []
    for i in range(n):
        m = json.loads(json.dumps(testclip.DHDR10_META))
        m["TargetedSystemDisplayMaximumLuminance"] = 100 + i
        scenes.append(m)
    path = tmp_path / "hdr10plus.json"
    path.write_text(json.dumps({"SceneInfo": scenes}))
    got, want, enc = _both([("qp", "30"), ("dhdr10-info", str(path))],
                           _small_frames(n), bframes=2, b_adapt=0,
                           scenecut=0)
    assert got == want
    _sps, _first, lums = testclip.stream_hdr10(got)
    pocs = [s["poc"] for s in enc.frame_stats]
    assert pocs != sorted(pocs)                 # reordered by B frames
    assert lums == [100 + poc for poc in pocs]


@pytest.mark.parametrize("hold", [4, 2])
def test_dhdr10_opt_dedupes(tmp_path, hold):
    """--dhdr10-opt: an unchanged payload is written on keyframes only
    (tests/test_apps_io.py:98: hold 4, the IDR's SEI alone), a changed one
    where it changes (hold 2)."""
    n = 4
    path = testclip.write_dhdr10_json(tmp_path / "hdr10plus.json", n, hold)
    got, want, enc = _both([("qp", "30"), ("dhdr10-info", path),
                            ("dhdr10-opt", "1")], _small_frames(n),
                           bframes=0, scenecut=0)
    assert got == want
    _sps, _first, lums = testclip.stream_hdr10(got)
    types = [s["type"] for s in enc.frame_stats]
    pocs = [s["poc"] for s in enc.frame_stats]
    assert lums == testclip.dhdr10_expected(types, pocs, n, hold)
    assert sum(v is not None for v in lums) == (1 if hold == 4 else 2)


def test_hdr10_seis_and_vui():
    """Mastering display, content light level and the colour description
    (tests/test_hdr10.py:41), and --hdr10's BT.2020/PQ shortcut (:67)."""
    frames = [(np.random.default_rng(5).integers(0, 255, (64, 96))
               .astype(np.uint8), np.full((32, 48), 120, np.uint8),
               np.full((32, 48), 130, np.uint8))]
    opts = [("qp", "30"), ("master-display", testclip.MASTER_DISPLAY),
            ("max-cll", "1000,400"), ("colorprim", "bt2020"),
            ("transfer", "smpte2084"), ("colormatrix", "bt2020nc")]
    got, want, _enc = _both(opts, frames, preset="medium", bframes=0,
                            sao=False, aq_mode=0, cu_tree=False)
    assert got == want
    sps, first, _lums = testclip.stream_hdr10(got)
    assert struct.unpack(">6H2H2I", first[SEI_MASTERING_DISPLAY]) == (
        13250, 34500, 7500, 3000, 34000, 16000, 15635, 16450, 10000000, 1)
    assert struct.unpack(">2H", first[SEI_CONTENT_LIGHT_LEVEL]) == (1000,
                                                                    400)
    assert (sps.colour_primaries, sps.transfer_characteristics,
            sps.matrix_coeffs) == (9, 16, 9)
    p = TP.param_default_preset("medium")
    p.width, p.height, p.bframes = 96, 64, 0
    TP.param_parse(p, "qp", "30")
    TP.param_parse(p, "hdr10")
    enc = TEncoder(p, device="cpu")
    assert (enc.sps.colour_primaries, enc.sps.transfer_characteristics,
            enc.sps.matrix_coeffs) == (9, 16, 9)


def _clip10(w=96, h=64, n=4):
    return testclip.lift10(testclip.make_ramp_clip(w, h, n, seed=12), 12)


@pytest.mark.parametrize("extra", [[], ["--output-depth", "8"],
                                   ["--output-depth", "8", "--dither"]],
                         ids=["main10", "depth8", "depth8_dither"])
def test_cli_10bit_input_same_bytes(tmp_path, extra):
    """A 10-bit Y4M through both CLIs: the same stream, and the same
    --recon Y4M (10-bit samples at Main10)."""
    from x265_tpu.cli import main as jmain
    from x265_tpu.io.y4m import Y4MReader
    from x265_tpu_torch.cli import main as tmain
    from x265_tpu_torch.io.y4m import VideoInfo, write_y4m
    frames = _clip10()
    src = tmp_path / "in.y4m"
    write_y4m(str(src), frames, VideoInfo(96, 64, 25, 1, bit_depth=10))
    common = ["--input", str(src), "--preset", "fast", "--tune",
              "zerolatency", "--qp", "30", "--scenecut", "0"] + extra
    outs = []
    for name, main, dev in (("t", tmain, ["--device", "cpu"]),
                            ("j", jmain, [])):
        out, rec = tmp_path / f"{name}.hevc", tmp_path / f"{name}.y4m"
        assert main(common + ["--output", str(out), "--recon", str(rec)]
                    + dev) == 0
        r = Y4MReader(str(rec))
        outs.append((out.read_bytes(), r.info.bit_depth, list(r.frames())))
        r.close()
    (got, gbd, grec), (want, wbd, wrec) = outs
    assert got == want
    assert gbd == wbd == (8 if extra else 10)
    assert len(grec) == len(wrec) == len(frames)
    for a, b in zip(grec, wrec):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    if not extra:
        assert max(int(f[0].max()) for f in grec) > 255


def test_dither_image_equals_the_reference():
    """io/dither.py against the JAX package's (tests/test_apps_io.py:163):
    a smooth ramp and a seeded 10-bit picture, to 8 bits, and the
    pass-through when nothing is reduced."""
    from x265_tpu.io.dither import dither_image as jd
    from x265_tpu_torch.io.dither import dither_image as td
    ramp = np.tile(np.linspace(0, 1023, 512).astype(np.uint16), (64, 1))
    pic = _clip10()[1]
    for planes in ((ramp, ramp[:32, :256], ramp[:32, :256]), pic):
        for src, dst in ((10, 8), (10, 10), (10, 9)):
            got, want = td(planes, src, dst), jd(planes, src, dst)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and np.array_equal(a, b)
    y8 = td((ramp, ramp, ramp), 10, 8)[0]
    assert y8.max() <= 255
    true = ramp.astype(float) / 4.0
    assert abs((y8.astype(float) - true).mean()) < 0.05
