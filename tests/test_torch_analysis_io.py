"""Analysis save/load in the port (x265_tpu_torch/api/analysis_io.py and
the reader/writer branches of Encoder) against the JAX package: the file
round trip, files that one package writes read into equal decisions in
the other, the half- and double-size rescales, save -> load giving the
identical stream (and the JAX package's), the --scale-factor 2 chain
(golden case `medium_analysis_load_sf2`), set/get_analysis_data, and the
guards of the two places where the reference's chain breaks."""
import numpy as np
import pytest

from x265_tpu.api import analysis_io as jio
from x265_tpu.api import params as JP
from x265_tpu.api.encoder import Encoder as JEncoder
from x265_tpu_torch.api import analysis_io as tio
from x265_tpu_torch.api import params as TP
from x265_tpu_torch.api.encoder import Encoder as TEncoder
from x265_tpu_torch.engine.ctu_writer import FrameDecisions
from x265_tpu_torch.utils import profiling, testclip
from torch_port_util import assert_decodes_to_recon, golden_encoders


def _decisions(seed, inter=True):
    rng = np.random.default_rng(seed)
    h8, w8 = 16, 24
    return FrameDecisions(
        cu_log2_map=rng.integers(3, 6, (h8, w8)).astype(np.int32),
        luma_mode8=rng.integers(0, 35, (h8, w8)).astype(np.int32),
        chroma_mode8=(rng.integers(0, 5, (h8, w8)).astype(np.int32)
                      if inter else None),
        inter8=rng.integers(0, 2, (h8, w8)).astype(bool) if inter else None,
        dir8=rng.integers(1, 4, (h8, w8)).astype(np.int32) if inter else None,
        mv8=(rng.integers(-64, 64, (h8, w8, 2, 2)).astype(np.int32)
             if inter else None),
        ref8=rng.integers(0, 3, (h8, w8)).astype(np.int32) if inter else None,
        qp_map=rng.integers(20, 40, (2, 3)).astype(np.int32))


def _fields_equal(a, b):
    for k in tio._FIELDS:
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if x is not None:
            assert np.array_equal(np.asarray(x), np.asarray(y)), k
            assert np.asarray(x).dtype == np.asarray(y).dtype, k


def test_fields_and_magic_are_the_reference_format():
    assert tio.MAGIC == jio.MAGIC and tio._FIELDS == jio._FIELDS


def test_round_trip(tmp_path):
    decs = [_decisions(1, inter=False), _decisions(2), _decisions(3)]
    w = tio.AnalysisWriter(str(tmp_path / "a.dat"))
    for d in decs:
        w.put(d)
    w.close()
    r = tio.AnalysisReader(str(tmp_path / "a.dat"))
    for d in decs:
        _fields_equal(r.get(), d)
    assert r.get() is None
    r.close()
    (tmp_path / "bad.dat").write_bytes(b"not an analysis file")
    with pytest.raises(ValueError):
        tio.AnalysisReader(str(tmp_path / "bad.dat"))


@pytest.mark.parametrize("writer,reader", [(jio, tio), (tio, jio)],
                         ids=["jax_to_port", "port_to_jax"])
def test_files_cross_packages(tmp_path, writer, reader):
    """A file one package writes reads into equal decisions in the other
    (and the two writers write the same bytes)."""
    decs = [_decisions(4, inter=False), _decisions(5)]
    paths = []
    for mod in (writer, reader):
        paths.append(str(tmp_path / f"{mod.__name__}.dat"))
        w = mod.AnalysisWriter(paths[-1])
        for d in decs:
            w.put(d)
        w.close()
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    r = reader.AnalysisReader(paths[0])
    for d in decs:
        got = r.get()
        assert type(got).__module__ == (
            reader.__name__.split(".")[0] + ".engine.ctu_writer")
        _fields_equal(got, d)
    assert r.get() is None
    r.close()


@pytest.mark.parametrize("inter", [False, True])
def test_scale_and_upscale_decisions_equal_the_reference(inter):
    d = _decisions(6, inter=inter)
    _fields_equal(tio.scale_decisions(d, 2), jio.scale_decisions(d, 2))
    for ctb in (5, 6):
        _fields_equal(tio.upscale_decisions(d, 2, ctb),
                      jio.upscale_decisions(d, 2, ctb))


def _abr_params(P, path, key):
    p = P.param_default_preset("medium")
    P.param_parse(p, "bitrate", "100")
    P.param_parse(p, key, path)
    p.width, p.height = 192, 128
    return p


def test_save_load_identical_stream_equal_to_jax(tmp_path):
    """medium + ABR with B frames: the load encode codes the saved
    decisions without its own motion search or RD passes and gives the
    save encode's stream, which is the JAX package's."""
    frames = testclip.make_clip(192, 128, 9, 3)
    a = str(tmp_path / "port.dat")
    profiling.reset()
    saved = TEncoder(_abr_params(TP, a, "analysis-save"),
                     device="cpu").encode(frames)
    stages_save = profiling.report()
    profiling.reset()
    enc = TEncoder(_abr_params(TP, a, "analysis-load"), device="cpu")
    got = {}
    enc.recon_sink = lambda i, planes: got.__setitem__(i, planes)
    loaded = enc.encode(frames)
    stages_load = profiling.report()
    assert loaded == saved
    for st in ("motion", "rd_adopt", "rd_promote"):
        assert stages_save[st]["calls"] > 0, st
        assert st not in stages_load, st
    types = "".join(s["type"] for s in enc.frame_stats)
    assert types[0] == "I" and "P" in types and "B" in types
    j = str(tmp_path / "jax.dat")
    ref = JEncoder(_abr_params(JP, j, "analysis-save")).encode(frames)
    assert ref == saved
    assert open(a, "rb").read() == open(j, "rb").read()
    # the JAX package's file drives the port's load to the same stream
    assert TEncoder(_abr_params(TP, j, "analysis-load"),
                    device="cpu").encode(frames) == saved
    assert_decodes_to_recon(loaded, [got[i] for i in sorted(got)],
                            len(frames))


def test_scale_factor_2_chain(tmp_path):
    """x265's chain (cli.rst 942-980): the analysis saved from the
    half-size source seeds the full-size encode with --scale-factor 2;
    the stream equals the JAX package's."""
    enc, stream, recons, gold, frames = golden_encoders(
        "medium_analysis_load_sf2", str(tmp_path))
    assert enc.param.scale_factor == 2 and enc.param.ctu_size == 32
    assert "".join(s["type"] for s in enc.frame_stats) == gold["types"]
    # the loaded CU sizes are the saved ones, doubled
    half = tio.AnalysisReader(enc.param.analysis_load)
    first = half.get()
    half.close()
    assert first.cu_log2_map.shape == (8, 12)
    assert_decodes_to_recon(stream, recons, len(frames))


def _tail_params(P, **kw):
    p = P.param_default_preset("ultrafast")
    p.width, p.height = 96, 64
    p.bframes = kw.pop("bframes", 0)
    p.scenecut = kw.pop("scenecut", 0)
    P.param_parse(p, "qp", str(kw.pop("qp", 30)))
    for k, v in kw.items():
        setattr(p, k, v)
    return p


def _tail_frames(n, seed=5, h=64, w=96):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h, w)).astype(np.uint8)
    return [(np.roll(base, 2 * i, axis=1),
             np.full((h // 2, w // 2), 120, np.uint8),
             np.full((h // 2, w // 2), 130, np.uint8)) for i in range(n)]


def test_set_get_analysis_data():
    """In-memory analysis reuse (tests/test_api_tail.py:53 in the port):
    feeding a picture's own recorded decisions back reproduces the
    identical stream, which is the JAX package's."""
    frames = _tail_frames(1)
    enc = TEncoder(_tail_params(TP, keyint=1), device="cpu")
    bs1 = enc.encode_frame(*frames[0]) + enc.flush()
    dec = enc.get_analysis_data()
    assert isinstance(dec, FrameDecisions)
    enc2 = TEncoder(_tail_params(TP, keyint=1), device="cpu")
    enc2.set_analysis_data(dec)
    bs2 = enc2.encode_frame(*frames[0]) + enc2.flush()
    assert bs1 == bs2
    assert enc2._analysis_queue == []
    jenc = JEncoder(_tail_params(JP, keyint=1))
    assert jenc.encode_frame(*frames[0]) + jenc.flush() == bs1


def test_chain_faults_of_the_reference_raise(tmp_path):
    """The two places where the reference's --scale-factor 2 chain
    breaks raise in the port, naming the cause: a saved 32x32 intra CU
    that would become a 64x64 intra CU under 64x64 CTUs (the reference's
    writer asserts), and a saved per-CTB QP map of the half-size grid
    (the reference's writer reads past its end)."""
    frames = testclip.make_clip(192, 128, 2, 3)
    half = [tuple(np.ascontiguousarray(p[::2, ::2]) for p in f)
            for f in frames]

    def params(w, h, **kw):
        p = TP.param_default_preset("medium")
        TP.param_parse(p, "qp", "30")
        for k, v in kw.items():
            TP.param_parse(p, k, v)
        p.width, p.height = w, h
        return p
    a = str(tmp_path / "a.dat")
    w = tio.AnalysisWriter(a)
    d = _decisions(7, inter=False)
    d.cu_log2_map = np.full((8, 12), 5, np.int32)
    d.qp_map = None
    w.put(d)
    w.close()
    with pytest.raises(NotImplementedError, match="64x64 intra CU"):
        TEncoder(params(192, 128, **{"analysis-load": a,
                                     "scale-factor": "2"}),
                 device="cpu").encode(frames[:1])
    b = str(tmp_path / "b.dat")
    TEncoder(params(96, 64, **{"analysis-save": b, "ctu": "32"}),
             device="cpu").encode(half[:1])
    with pytest.raises(ValueError, match="qp_map"):
        TEncoder(params(192, 128, **{"analysis-load": b, "scale-factor": "2",
                                     "ctu": "32"}),
                 device="cpu").encode(frames[:1])
