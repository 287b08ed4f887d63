"""Encodes steered from outside the encoder, in the port against the JAX
package: --qpfile (a forced IDR and QP; a forced CRA and a B picture's QP
under open GOP with queued B frames: tests/test_api_misc.py:178,205),
--zones with q= and b= (tests/test_zones.py), per-CTU QP offsets
(set_ctu_info, tests/test_api_tail.py:70), and the golden cases
`medium_qpfile_zones` and `medium_roi`. Streams and frame statistics equal
the JAX package's; the golden streams decode in the port's decoder to
the encoder's recon."""
import numpy as np
import pytest

from x265_tpu.api import params as JP
from x265_tpu.api.encoder import Encoder as JEncoder
from x265_tpu_torch.api import params as TP
from x265_tpu_torch.api.encoder import Encoder as TEncoder
from torch_port_util import assert_decodes_to_recon, golden_encoders


def _both(build, frames):
    """(port encoder, port stream, JAX encoder, JAX stream) of the same
    Param builder (a function of a package's params module)."""
    enc = TEncoder(build(TP), device="cpu")
    jenc = JEncoder(build(JP))
    got, want = enc.encode(frames), jenc.encode(frames)
    assert enc.frame_stats == jenc.frame_stats
    return enc, got, jenc, want


def test_qpfile_forces_keyframe_and_qp(tmp_path):
    rng = np.random.default_rng(3)
    frames = [(rng.integers(0, 255, (64, 64)).astype(np.uint8),
               np.full((32, 32), 120, np.uint8),
               np.full((32, 32), 130, np.uint8)) for _ in range(6)]
    qf = tmp_path / "qp.txt"
    qf.write_text("0 I 30\n3 I 25\n")

    def build(P):
        p = P.param_default_preset("ultrafast")
        p.width = p.height = 64
        p.rc_mode, p.qp, p.bframes = P.RC_CQP, 34, 0
        p.keyint, p.scenecut, p.open_gop = 250, 0, False
        p.qpfile = str(qf)
        return p
    enc, got, _jenc, want = _both(build, frames)
    assert got == want
    forced = [s for s in enc.frame_stats if s["type"] == "I"]
    assert [s["qp"] for s in forced] == [30, 25]


def test_qpfile_open_gop_bframes(tmp_path):
    rng = np.random.default_rng(7)
    base = rng.integers(0, 255, (64, 64)).astype(np.int32)
    frames = [(np.clip(np.roll(base, 2 * i, 1)
                       + rng.integers(-3, 4, (64, 64)), 0, 255)
               .astype(np.uint8),
               np.full((32, 32), 120, np.uint8),
               np.full((32, 32), 130, np.uint8)) for i in range(8)]
    qf = tmp_path / "qp.txt"
    qf.write_text("# comment\n2 B 40\nnot-a-number x\n4 K 26\n")

    def build(P):
        p = P.param_default_preset("medium")
        p.width = p.height = 64
        p.rc_mode, p.qp = P.RC_CQP, 34
        p.bframes = 2
        p.keyint, p.scenecut = 250, 0
        p.aq_mode, p.cu_tree, p.sao = 0, False, False
        assert p.open_gop
        p.qpfile = str(qf)
        return p
    enc, got, _jenc, want = _both(build, frames)
    assert got == want
    istats = [s for s in enc.frame_stats if s["type"] == "I"]
    assert len(istats) == 2 and istats[1]["qp"] == 26    # the forced CRA
    bstats = [s for s in enc.frame_stats if s["qp"] == 40]
    assert len(bstats) == 1 and bstats[0]["type"] == "B"


def _zone_clip(n=9, w=96, h=64, seed=2):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h, w)).astype(np.int32)
    frames = []
    for _ in range(n):
        y = np.clip(base + rng.integers(-8, 8, (h, w)), 0, 255)
        frames.append((y.astype(np.uint8),
                       np.full((h // 2, w // 2), 120, np.uint8),
                       np.full((h // 2, w // 2), 130, np.uint8)))
    return frames


def _zone_params(rc, zones):
    def build(P):
        p = P.param_default_preset("medium")
        p.width, p.height = 96, 64
        p.bframes, p.scenecut, p.aq_mode = 0, 0, 0
        p.cu_tree, p.sao = False, False
        P.param_parse(p, *rc)
        if zones:
            P.param_parse(p, "zones", zones)
        return p
    return build


def test_zone_forced_qp():
    enc, got, _jenc, want = _both(_zone_params(("qp", "30"), "3,5,q=18"),
                                  _zone_clip())
    assert got == want
    qps = {s["poc"]: s["qp"] for s in enc.frame_stats}
    assert [qps[i] for i in (3, 4, 5)] == [18, 18, 18]
    assert qps[1] != 18 and qps[7] != 18


@pytest.mark.parametrize("zones", ["", "0,20,b=2.0"])
def test_zone_bitrate_multiplier(zones):
    enc, got, _jenc, want = _both(_zone_params(("crf", "30"), zones),
                                  _zone_clip())
    assert got == want
    if zones:
        base = TEncoder(_zone_params(("crf", "30"), "")(TP), device="cpu")
        base.encode(_zone_clip())
        p_bits = [sum(s["bits"] for s in e.frame_stats if s["type"] == "P")
                  for e in (base, enc)]
        assert p_bits[1] > p_bits[0] * 1.2, p_bits


def test_set_ctu_info_changes_qp():
    rng = np.random.default_rng(5)
    base = rng.integers(0, 255, (64, 96)).astype(np.uint8)
    frame = (base, np.full((32, 48), 120, np.uint8),
             np.full((32, 48), 130, np.uint8))

    def encode(E, P, off, **kw):
        p = P.param_default_preset("ultrafast")
        p.width, p.height = 96, 64
        p.bframes = p.scenecut = 0
        p.aq_mode = 1
        P.param_parse(p, "qp", "30")
        enc = E(p, **kw)
        if off is not None:
            enc.set_ctu_info(0, off)
        return enc, enc.encode_frame(*frame) + enc.flush()
    grid = TP.param_default_preset("ultrafast")
    grid.width, grid.height = 96, 64
    off = np.zeros((grid.pic_height_in_ctbs, grid.pic_width_in_ctbs),
                   np.int32)
    assert off.shape == (2, 3)                  # 32x32 CTBs
    off[0, 0] = 8
    enc, bs1 = encode(TEncoder, TP, off, device="cpu")
    _e, bs2 = encode(TEncoder, TP, None, device="cpu")
    assert bs1 != bs2
    assert enc._ctu_info == {}                      # consumed by picture 0
    _j, ref = encode(JEncoder, JP, off)
    assert bs1 == ref
    qmap = enc.get_analysis_data().qp_map
    assert qmap[0, 0] > qmap[0, 1]


@pytest.mark.parametrize("name", ["medium_qpfile_zones", "medium_roi"])
def test_golden_steered_cases(name, tmp_path):
    enc, stream, recons, jenc, ref, frames = golden_encoders(name,
                                                             str(tmp_path))
    assert stream == ref
    types = "".join(s["type"] for s in enc.frame_stats)
    assert types == "".join(s["type"] for s in jenc.frame_stats)
    qps = [s["qp"] for s in enc.frame_stats]
    if name == "medium_qpfile_zones":
        assert enc.rc.zones and len(enc._qpfile) == 4
        assert types.count("I") == 3               # 0, a CRA and an IDR
        assert 27 in qps and 24 in qps and 38 in qps and 33 in qps
    else:
        assert enc._ctu_info == {}                 # both maps consumed
    assert_decodes_to_recon(stream, recons, len(frames))


def test_calculate_vmaf_raises():
    with pytest.raises(NotImplementedError, match="libvmaf"):
        TEncoder.calculate_vmaf()
