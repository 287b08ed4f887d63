"""Two-pass ABR in the port (golden case `medium_twopass`: medium, ABR 100
kbps, 192x128, 11 frames): pass 1 writes the per-picture stats (with
its cuTree offsets) when the encode closes, pass 2 plans every QP from
them and reuses the offsets. The pass-1 stats file equals the JAX
package's text for text, the pass-2 stream equals the JAX package's (held
against the committed golden digest) and decodes in the port's decoder
to the encoder's recon; pass 2 is deterministic; the CLI's --pass/--stats
reach the same encoder through param_parse."""
import hashlib
import json
import os

from x265_tpu.api import params as JP
from x265_tpu.api.encoder import Encoder as JEncoder
from x265_tpu_torch.api import params as TP
from x265_tpu_torch.api.encoder import Encoder as TEncoder
from x265_tpu_torch.utils import testclip
from torch_port_util import assert_decodes_to_recon, recon_collector

NAME = "medium_twopass"


def _port(p):
    return TEncoder(p, device="cpu")


def test_pass1_stats_and_pass2_stream_equal_the_reference(tmp_path):
    frames = testclip.golden_clip(NAME)
    dirs = {k: tmp_path / k for k in ("port", "jax")}
    for d in dirs.values():
        d.mkdir()
    enc = _port(testclip.golden_params(NAME, TP, str(dirs["port"]),
                                       encoder=_port))
    recons = recon_collector(enc)
    stream, qp_maps = testclip.golden_stream(enc, NAME, frames)
    jenc = JEncoder(testclip.golden_params(NAME, JP, str(dirs["jax"]),
                                           encoder=JEncoder))
    ref, ref_qp_maps = testclip.golden_stream(jenc, NAME, frames)
    gold = testclip.golden_digests()[NAME]
    assert gold == {"sha256": hashlib.sha256(ref).hexdigest(),
                    "bytes": len(ref), "qp_maps": ref_qp_maps}, \
        f"golden entry of {NAME} is stale"
    stats = [open(os.path.join(d, f"{NAME}.stats")).read()
             for d in (dirs["port"], dirs["jax"])]
    assert stats[0] == stats[1]
    recs = [json.loads(line) for line in stats[0].splitlines()]
    assert len(recs) == len(frames)
    # the pass-1 cuTree offsets ride the stats file (every P anchor)
    assert any("cutree" in r for r in recs)
    assert stream == ref and qp_maps == ref_qp_maps
    assert enc.rc.pass_num == 2 and enc.rc.pass2_qp is not None
    # a record a picture, each taken by one rate-control start of pass 2
    # (one leaf B a mini-GOP here, so each record keeps its picture's
    # type: a longer run of pipelined B pictures shifts them, ROADMAP
    # Queue 3)
    assert [r["type"] for r in recs] == [s["type"] for s in enc.frame_stats]
    assert enc.rc.pass2_idx == len(enc.rc.pass2_qs) == len(recs)
    qps = [s["qp"] for s in enc.frame_stats]
    assert qps == [s["qp"] for s in jenc.frame_stats]
    assert_decodes_to_recon(stream, recons(), len(frames))


def test_pass2_is_deterministic(tmp_path):
    """tests/test_twopass.py:49 in the port: two pass-2 encodes of one
    stats file give the same stream."""
    frames = testclip.golden_clip(NAME)
    p = testclip.golden_params(NAME, TP, str(tmp_path), encoder=_port)
    a = _port(p).encode(frames)
    b = _port(p).encode(frames)
    assert a == b


def test_cli_two_pass(tmp_path):
    """--pass 1 --stats through the port's CLI writes the stats the
    library's pass 1 writes, and --pass 2 codes the library's stream."""
    from x265_tpu_torch.cli import main
    from x265_tpu_torch.io.y4m import VideoInfo, write_y4m
    frames = testclip.golden_clip(NAME)
    src = str(tmp_path / "in.y4m")
    write_y4m(src, frames, VideoInfo(*testclip.GOLDEN_SIZE[:2], 25, 1))
    stats = str(tmp_path / "cli.log")
    outs = []
    for n in (1, 2):
        outs.append(str(tmp_path / f"pass{n}.hevc"))
        assert main(["--input", src, "--output", outs[-1], "--preset",
                     "medium", "--bitrate", "100", "--pass", str(n),
                     "--stats", stats, "--device", "cpu"]) == 0
    lib = str(tmp_path / "lib")
    os.mkdir(lib)
    p2 = testclip.golden_params(NAME, TP, lib, encoder=_port)
    assert open(stats).read() == open(os.path.join(
        lib, f"{NAME}.stats")).read()
    assert open(outs[1], "rb").read() == _port(p2).encode(frames)
