"""Transform skip at 192x120 (utils/testclip.GOLDEN_CASES medium_tskip:
medium with B frames and SAO on screen content, whose second pass
recomputes every TB because the collected levels cannot carry the
transform_skip_flag, and whose device residual leaves out the 8x8 CUs of
the bottom 8 lines), byte-identical to the
JAX package's stream and decoded back with transform-skip TBs in it.
Then the port's native writer against its Python writer
(engine/ctu_writer.FrameSyntaxWriter) on a transform-skip picture and a
noise-reduction picture, as tests/test_tskip.py and
tests/test_noise_reduction.py hold the JAX package's."""
import copy
import types

import numpy as np
import pytest

from x265_tpu_torch import native
from x265_tpu_torch.decoder import decoder as dec_mod
from torch_port_util import assert_decodes_to_recon, golden_encoders


def test_tskip_sao_recompute_golden(monkeypatch):
    calls = []
    orig = native.encode_slice_px

    def spy(*a, **kw):
        # positional: a[3] the CU sizes, a[6] the inter map, a[11] refs
        cu8 = ((np.asarray(a[3]) == 3) & (np.asarray(a[6]) != 0)
               if a[6] is not None else None)
        calls.append((not kw["collect"], kw["sao_params"] is not None,
                      kw["pre"], cu8, a[11]))
        return orig(*a, **kw)
    monkeypatch.setattr(native, "encode_slice_px", spy)
    enc, stream, recons, gold, frames = golden_encoders("medium_tskip")
    p = enc.param
    assert p.tskip and p.sao and p.tu_inter_depth == 1
    assert enc.pps.transform_skip_enabled
    n = len(enc.frame_stats)
    mine = calls[:2 * n]          # the JAX package's calls come after
    # two full walks a picture, neither collect-only: the second (with
    # the SAO parameters) quantizes again from the device's TBs
    # (the B pipeline interleaves pictures, so pair them by their TBs)
    assert all(c[0] for c in mine)
    assert sum(c[1] for c in mine) == n
    passes = {}
    for c in mine:
        if c[2] is not None:
            passes.setdefault(id(c[2]), []).append(c[1])
    # the same device TBs in both passes: no replay planes
    assert sorted(passes.values()) == [[False, True]] * (n - 1)
    # the device residual leaves out its 8x8 class under --tskip (the
    # bottom 8 lines of 120 are 8x8 CUs): the native walk codes those
    # inter CUs itself, from the references' pixels, which the encoder
    # then materializes on the host; every larger inter CU stays on the
    # device
    inter = [c for c in mine if c[2] is not None and not c[1]]
    assert len(inter) == n - 1
    assert sum(int(c[3].sum()) for c in inter) > 0
    for c in inter:
        has8 = c[2]["has8"] != 0
        assert not has8[c[3]].any()
        assert has8.any()
        if c[3].any():
            assert all(np.asarray(r[0]).any() for lst in c[4] for r in lst)
    # the stream carries transform-skip TBs, and decodes to the recon
    hits = []
    tsr = dec_mod.transform_skip_residual
    monkeypatch.setattr(dec_mod, "transform_skip_residual",
                        lambda *a: hits.append(1) or tsr(*a))
    assert_decodes_to_recon(stream, recons, len(frames))
    assert len(hits) > 0


def _params(tskip=False, nr=0, size=(96, 64), **kw):
    """The JAX package's test_tskip/test_noise_reduction settings, through
    the port's params: medium at 96x64, fixed mini-GOPs, no scenecut, AQ,
    cuTree or SAO, QP 30."""
    from x265_tpu_torch.api.params import param_default_preset, param_parse
    p = param_default_preset("medium")
    p.width, p.height = size
    p.bframes = kw.pop("bframes", 1)
    p.b_adapt = 0
    p.scenecut = 0
    p.aq_mode = 0
    p.cu_tree = False
    p.sao = False
    param_parse(p, "qp", "30")
    if tskip:
        param_parse(p, "tskip")
    p.nr_intra = p.nr_inter = nr
    for k, v in kw.items():
        setattr(p, k, v)
    return p


def _noisy_frames(n, w=96, h=64, seed=6):
    """tests/test_noise_reduction.py's noisy clip."""
    rng = np.random.default_rng(seed)
    base = rng.integers(40, 210, (h, w)).astype(np.int32)
    return [(np.clip(base + rng.integers(-18, 18, (h, w)), 0, 255)
             .astype(np.uint8),
             np.full((h // 2, w // 2), 120, np.uint8),
             np.full((h // 2, w // 2), 130, np.uint8)) for _ in range(n)]


def _writer_pairs(p, frames):
    """Encode with the port (native writer) and code every picture again
    with the Python writer on the same decisions, references, offsets and
    slice header; returns [(slice type, native bytes, Python bytes,
    native NR sums, Python NR sums, TBs the Python writer transform-
    skipped)]."""
    from x265_tpu_torch.api.encoder import Encoder
    from x265_tpu_torch.engine.ctu_writer import FrameSyntaxWriter
    from x265_tpu_torch.hevc.headers import SLICE_B, SLICE_I
    enc = Encoder(p, device="cpu")
    out = []
    orig = enc._inter_slice_gen

    def spy(frame, sh, decisions, refs, ref_poc, poc, slice_type):
        col = None
        if slice_type != SLICE_I and p.tmvp:
            lst = ref_poc[0] if slice_type != SLICE_B else ref_poc[1]
            col = enc._colmv.get(lst[0]) if lst else None
        nr_before = copy.deepcopy(enc._nr)
        data, recon = yield from orig(frame, sh, decisions, refs, ref_poc,
                                      poc, slice_type)
        w = FrameSyntaxWriter(
            enc.sps, enc.pps, sh, p.lossless,
            refs=tuple([r.host() for r in lst] for lst in refs),
            ref_poc=ref_poc, cur_poc=poc, col=col)
        nr_sums = None
        if nr_before is not None:
            shim = types.SimpleNamespace(param=p, _nr=nr_before)
            w.nr = (Encoder._nr_offsets(shim),
                    np.zeros((16, 1024), np.uint32),
                    np.zeros(16, np.uint32))
            nr_sums = (enc._nr["sum"] - shim._nr["sum"],
                       enc._nr["cnt"] - shim._nr["cnt"])
        w.rdoq_level = p.rdoq_level
        w.psy_fx = int(round(p.psy_rdoq * 256)) if p.rdoq_level >= 2 else 0
        py = w.encode_slice_data(*(np.asarray(x) for x in frame), decisions)
        out.append((slice_type, data, py, nr_sums,
                    None if w.nr is None else (w.nr[1], w.nr[2]),
                    sum(w._tsmap.values())))
        return data, recon
    enc._inter_slice_gen = spy
    enc.encode(frames)
    return out


def test_tskip_native_matches_python_writer():
    """On screen content 56 lines high (its bottom 8 lines 8x8 CUs, the
    only CUs with 4x4 TBs: tests/test_tskip.py's 64 lines have none), with
    RDOQ as the JAX package's test runs it."""
    from x265_tpu_torch.utils.testclip import make_screen_clip
    pairs = _writer_pairs(_params(tskip=True, rdoq_level=2, size=(96, 56)),
                          make_screen_clip(96, 56, 3, seed=3))
    assert sorted({t for t, *_ in pairs}) == [0, 1, 2]    # B, P and I
    for t, data, py, *_ in pairs:
        assert data == py, t
    assert sum(x[5] for x in pairs) > 0         # transform skip was taken


@pytest.mark.parametrize("bframes", [0, 1])
def test_nr_native_matches_python_writer(bframes):
    """Equal bytes on every picture, and equal statistics on the inter
    pictures. The Python writer denoises inter TBs only (its intra chain,
    _tb_coeffs, has no NR step; so has the JAX package's copy), while the
    native writer also gathers and denoises intra TBs: on the I picture,
    whose offsets are still zero, the bytes agree and the intra sums do
    not (ROADMAP Queue 3)."""
    pairs = _writer_pairs(_params(nr=500, bframes=bframes),
                          _noisy_frames(4))
    assert len(pairs) == 4
    for t, data, py, nat_sums, py_sums, _ in pairs:
        assert data == py, t
        if t == 2:
            assert nat_sums[1][:8].sum() > 0 and py_sums[1].sum() == 0
            continue
        assert np.array_equal(nat_sums[0], py_sums[0].astype(np.uint64))
        assert np.array_equal(nat_sums[1], py_sums[1].astype(np.uint64))
    assert pairs[-1][3][1][8:].sum() > 0
