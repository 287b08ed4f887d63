"""The port stands alone: no module of x265_tpu_torch, nor chip_smoke.py,
imports jax or the JAX package — checked in the sources and, in a fresh
interpreter, in sys.modules after importing every module. Also: options
outside the ported slices raise, the ported ones are accepted (those of
the slow preset, lossless and keyint 1 among them), and no CUDA device
without an explicit CPU request raises."""
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "x265_tpu_torch")
_BAD = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|x265_tpu)(\.|\s|$)", re.M)


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _dirs, files in os.walk(PKG):
        if os.path.basename(d) in ("build", "__pycache__"):
            continue
        out += [os.path.join(d, f) for f in files
                if f.endswith((".py", ".cu", ".cpp", ".h"))]
    return sorted(out)


def test_sources_never_import_jax_or_the_jax_package():
    srcs = _sources()
    assert len(srcs) > 40
    for path in srcs:
        text = open(path, encoding="utf-8").read()
        assert not _BAD.search(text), path
        assert "import_module(\"jax" not in text, path
        assert "__import__(\"jax" not in text, path


def test_importing_every_module_loads_neither():
    code = (
        "import sys, pkgutil, importlib\n"
        "import x265_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "x265_tpu_torch.__path__, 'x265_tpu_torch.')]\n"
        "for n in names:\n"
        "    if n.endswith('__main__'):\n"
        "        continue\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'jaxlib' or m == 'x265_tpu' or "
        "m.startswith('x265_tpu.')]\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
        "new = ['x265_tpu_torch.api.analysis_io', 'x265_tpu_torch.api.ladder',"
        " 'x265_tpu_torch.io.scaler', 'x265_tpu_torch.io.reconplay',"
        " 'x265_tpu_torch.utils.checks', 'x265_tpu_torch.decoder.de265']\n"
        "assert all(n in names and n in sys.modules for n in new), new\n"
        "print(len(names))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) > 35


def _params(**kw):
    from x265_tpu_torch.api.params import param_default_preset, param_parse
    p = param_default_preset("ultrafast", "zerolatency")
    for k, v in (("qp", "30"), ("scenecut", "0"), ("ref", "1")):
        param_parse(p, k, v)
    p.width, p.height = 64, 64
    for k, v in kw.items():
        setattr(p, k, v)
    return p


@pytest.mark.parametrize("name,kw", [("ref 5", dict(ref=5))],
                         ids=["ref 5-kw2"])
def test_unsupported_option_raises_naming_it(name, kw):
    from x265_tpu_torch.api.encoder import Encoder
    with pytest.raises(NotImplementedError) as ei:
        Encoder(_params(**kw), device="cpu")
    assert name in str(ei.value)


@pytest.mark.parametrize("name,kw", [
    ("nr_intra", dict(nr_intra=5)), ("nr_inter", dict(nr_inter=5)),
    ("hist_scenecut", dict(hist_scenecut=True)),
    ("frame_dup qpfile", dict(frame_dup=True, qpfile="<qpfile>")),
    ("frame_dup", dict(frame_dup=True)),
    ("intra_refresh", dict(intra_refresh=True)),
    ("tskip", dict(tskip=True)), ("slices", dict(slices=2)),
    ("wpp", dict(wpp=True)),
])
def test_structure_options_encode(name, kw, tmp_path):
    """The stream-structure and live-robustness options are ported (they
    raised until the slice that ported them): the encoder opens, signals
    each where the stream carries it, and encodes two pictures with it
    that the port's decoder reads back to the encoder's recon."""
    if kw.get("qpfile") == "<qpfile>":
        (tmp_path / "qp.txt").write_text("1 I 30\n")
        kw = dict(kw, qpfile=str(tmp_path / "qp.txt"))
    import numpy as np
    from x265_tpu_torch.api.encoder import Encoder
    from x265_tpu_torch.decoder.decoder import HEVCDecoder
    from x265_tpu_torch.utils.testclip import make_clip
    enc = Encoder(_params(**kw), device="cpu")
    assert enc.sps.frame_field_info == bool(kw.get("frame_dup"))
    assert enc.pps.transform_skip_enabled == bool(kw.get("tskip"))
    assert enc.pps.entropy_coding_sync_enabled == bool(kw.get("wpp"))
    assert (enc._nr is not None) == bool(kw.get("nr_intra")
                                         or kw.get("nr_inter"))
    recons = {}
    enc.recon_sink = lambda i, planes: recons.__setitem__(i, planes)
    frames = make_clip(64, 64, 2, seed=5)
    stream = enc.encode(frames)
    pics = HEVCDecoder().decode(stream)
    assert len(pics) == len(recons) == 2
    for pic, i in zip(pics, sorted(recons)):
        for a, b in zip((pic.y, pic.cb, pic.cr), recons[i]):
            assert np.array_equal(np.asarray(a), np.asarray(b))
    if name.startswith("nr_"):
        assert enc._nr["cnt"].sum() > 0      # the sums were gathered


@pytest.mark.parametrize("kw", [
    dict(aq_mode=1), dict(cu_tree=True), dict(deblock=True), dict(sao=True),
    dict(weightp=True),
    dict(deblock=True, sao=True, aq_mode=2, weightp=True, cu_tree=True)],
    ids=["aq_mode", "cu_tree", "deblock", "sao", "weightp", "all"])
def test_filter_options_are_accepted(kw):
    """The loop filters, AQ, weightp and cu_tree are ported."""
    from x265_tpu_torch.api.encoder import Encoder
    enc = Encoder(_params(**kw), device="cpu")
    assert enc.pps.deblocking_filter_disabled == (not kw.get("deblock"))
    assert enc.pps.weighted_pred == bool(kw.get("weightp"))
    assert enc.pps.cu_qp_delta_enabled == bool(
        kw.get("aq_mode") or kw.get("cu_tree"))
    assert enc.sps.sao_enabled == bool(kw.get("sao"))


@pytest.mark.parametrize("name,kw", [
    ("rd_level", dict(rd_level=4)), ("rdoq_level", dict(rdoq_level=1)),
    ("tu_inter_depth", dict(tu_inter_depth=2)),
    ("lossless", dict(lossless=True)), ("keyint 1", dict(keyint=1))])
def test_slow_and_lossless_options_are_accepted(name, kw):
    """rd 4, RDOQ, the explicit inter RQT, lossless and all-intra are
    ported (they raised until the slice that ported them): the encoder
    opens and signals each in its parameter sets."""
    from x265_tpu_torch.api.encoder import Encoder
    enc = Encoder(_params(**kw), device="cpu")
    p = enc.param
    lossless = bool(kw.get("lossless"))
    assert enc.pps.transquant_bypass_enabled == lossless
    assert enc.pps.sign_data_hiding == (p.sign_hide and not lossless)
    assert enc.sps.max_transform_hierarchy_depth_inter == (
        p.tu_inter_depth - 1)
    if name == "tu_inter_depth":
        assert enc.sps.max_transform_hierarchy_depth_inter == 1
    elif name == "lossless":
        assert p.qp == 4 and p.rdoq_level == 0
        assert not enc.pps.cu_qp_delta_enabled
    elif name == "keyint 1":
        assert not enc.ipp and enc.sps.max_dec_pic_buffering == 1
    else:
        assert getattr(p, name) == kw[name]


@pytest.mark.parametrize("kw", [
    dict(rc_mode=0, bitrate=500), dict(rc_mode=2, crf=23.0),
    dict(rc_mode=0, bitrate=500, vbv_maxrate=500, vbv_bufsize=500),
    dict(scenecut=40), dict(cu_tree=True, scenecut=40), dict(rd_level=3)],
    ids=["ABR", "CRF", "VBV", "scenecut", "cu_tree_lookahead", "rd_level_3"])
def test_live_options_are_accepted(kw):
    """Rate control other than CQP, VBV, scenecut (the lookahead), cuTree
    with the lookahead and rd 3 are ported."""
    from x265_tpu_torch.api.encoder import Encoder
    enc = Encoder(_params(**kw), device="cpu")
    assert enc.param.rd_level == kw.get("rd_level", enc.param.rd_level)


@pytest.mark.parametrize("name,opts", [
    ("scaling_lists", [("scaling-list", "default")]),
    ("bit_depth 10", [("output-depth", "10")]),
    ("main10 hdr10", [("output-depth", "10"), ("scaling-list", "default"),
                      ("hdr10", "1"), ("hdr10-opt", "1"),
                      ("max-cll", "1000,400")])])
def test_main10_options_are_accepted(name, opts):
    """Scaling lists, Main10 and the HDR10 options are ported (the first
    two raised until the slice that ported them): the encoder opens and
    signals each in its SPS."""
    from x265_tpu_torch.api.encoder import Encoder
    from x265_tpu_torch.api.params import param_parse
    p = _params()
    for k, v in opts:
        param_parse(p, k, v)
    enc = Encoder(p, device="cpu")
    ten = p.bit_depth == 10
    assert enc.sps.bit_depth == (10 if ten else 8)
    assert enc.sps.ptl.profile_idc == (2 if ten else 1)
    assert enc.sps.scaling_list_enabled == (name != "bit_depth 10")
    assert enc.sps.scaling_list_data is None     # the default matrices
    if name == "main10 hdr10":
        assert (enc.sps.colour_primaries, enc.sps.transfer_characteristics,
                enc.sps.matrix_coeffs) == (9, 16, 9)
        assert enc.param.hdr10_opt and enc.sps.vui_present


@pytest.mark.parametrize("name", ["pass_num 1", "pass_num 2", "zones",
                                  "qpfile", "analysis_save",
                                  "analysis_load"])
def test_steered_options_are_accepted(name, tmp_path):
    """Two-pass, zones, qpfile and analysis save/load are ported (they
    raised until the slice that ported them): the encoder opens, reads
    what it must read at once and keeps the option."""
    from x265_tpu_torch.api.analysis_io import AnalysisWriter
    from x265_tpu_torch.api.encoder import Encoder
    f = str(tmp_path / "fixture")
    kw = {"pass_num 1": dict(pass_num=1, stats_file=f),
          "pass_num 2": dict(pass_num=2, stats_file=f),
          "zones": dict(zones="0,10,q=20/11,20,b=1.5"),
          "qpfile": dict(qpfile=f),
          "analysis_save": dict(analysis_save=f),
          "analysis_load": dict(analysis_load=f)}[name]
    if name == "pass_num 2":
        open(f, "w").write('{"type": "I", "bits": 8000, "qscale": 1.0}\n')
    elif name == "qpfile":
        open(f, "w").write("0 I 30\n5 K 20\n")
    elif name == "analysis_load":
        AnalysisWriter(f).close()
    enc = Encoder(_params(**kw), device="cpu")
    p = enc.param
    if name.startswith("pass_num"):
        assert enc.rc.pass_num == p.pass_num
        assert (enc.rc.pass2_qp is not None) == (p.pass_num == 2)
    elif name == "zones":
        assert [z["start"] for z in enc.rc.zones] == [0, 11]
    elif name == "qpfile":
        assert enc._qpfile == {0: ("I", 30), 5: ("K", 20)}
    elif name == "analysis_save":
        enc.close()
        assert open(f, "rb").read(9) == b"X265TPUA1"
    else:
        assert enc._areader.get() is None


def test_bit_depth_raises():
    """12 bits stays refused (check_params refuses it in both packages,
    naming bit_depth); 10 is ported (test_main10_options_are_accepted)."""
    from x265_tpu_torch.api.encoder import Encoder, _check_supported
    from x265_tpu_torch.api.params import param_parse
    p = _params()
    param_parse(p, "output-depth", "12")
    with pytest.raises(ValueError, match="bit_depth"):
        Encoder(p, device="cpu")
    p.bit_depth = 12
    with pytest.raises(NotImplementedError, match="bit_depth 12"):
        _check_supported(p)


def test_device_none_without_cuda_raises():
    import numpy as np
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from x265_tpu_torch.api.encoder import Encoder
    from x265_tpu_torch.engine.me import motion_fused
    from x265_tpu_torch.models.intra_frame import decide_intra_frame_tpu
    from x265_tpu_torch.utils.device import resolve_device
    with pytest.raises(RuntimeError, match="CUDA"):
        Encoder(_params())
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    y = np.zeros((64, 64), np.uint8)
    with pytest.raises(RuntimeError, match="CUDA"):
        motion_fused(y, [y], 64, 64)
    with pytest.raises(RuntimeError, match="CUDA"):
        decide_intra_frame_tpu(y, 64, 64)
    assert resolve_device("cpu").type == "cpu"


def test_lookahead_and_rd_entry_points_default_to_cuda():
    """The lookahead and the RD passes take device=None as CUDA too,
    and raise before any work when there is no card."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from x265_tpu_torch.engine.lookahead import Lookahead
    from x265_tpu_torch.models.intra_rdo import rd_intra_promote32
    from x265_tpu_torch.models.rdo import (rd_adopt16, rd_promote,
                                           rd_promote32)
    with pytest.raises(RuntimeError, match="CUDA"):
        Lookahead(64, 64)
    for fn, nargs in ((rd_promote, 9), (rd_promote32, 9), (rd_adopt16, 10),
                      (rd_intra_promote32, 4)):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(*([None] * nargs))


def test_bframe_entry_points_default_to_cuda():
    """The B-frame entry points (the leaf-B batch's motion search and
    intra analysis, the slice-type search), the scaler (area and
    polyphase) and the ABR ladder take device=None as CUDA and raise
    before any work when there is no card."""
    import numpy as np
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from x265_tpu_torch.engine.lookahead import (batched_pair_costs,
                                                 slicetype_split)
    from x265_tpu_torch.engine.me import motion_fused_frames
    from x265_tpu_torch.models.intra_frame import (
        submit_intra_analysis_batch)
    y = np.zeros((64, 64), np.uint8)
    low = np.zeros((32, 32), np.int32)
    from x265_tpu_torch.api.ladder import AbrLadder, Rendition
    from x265_tpu_torch.io.scaler import scale_plane
    for call in (lambda: scale_plane(y, 32, 32),
                 lambda: AbrLadder(64, 64, [Rendition(64, 64, 100)]),
                 lambda: scale_plane(y, 48, 48),
                 lambda: motion_fused_frames([y, y], [y, y], 64, 64,
                                             do_bi=True),
                 lambda: submit_intra_analysis_batch([y, y], 64, 64),
                 lambda: batched_pair_costs([(low, low)]),
                 lambda: slicetype_split(low, [low, low])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_chip_smoke_fails_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       capture_output=True, text=True)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_native_loader_raises_when_the_build_fails(tmp_path, monkeypatch):
    from x265_tpu_torch import native
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_SO", str(tmp_path / "nope.so"))
    monkeypatch.setattr(native, "_BUILD", str(tmp_path))
    monkeypatch.setattr(native, "_SRC", str(tmp_path / "missing.cpp"))
    monkeypatch.setattr(native, "_needs_build", lambda: True)
    with pytest.raises(RuntimeError, match="build failed"):
        native.get_lib()
