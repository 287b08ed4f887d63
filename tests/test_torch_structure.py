"""The host pieces of the stream-structure slice against the JAX
package's, on identical numpy inputs: the noise-reduction offsets (with
the halving above the block limits), the luma histogram and its scene
cut at 8 and 10 bits, the intra-refresh column (with promoted 64x64 CUs),
the WPP entry points across an emulation-prevention byte at a substream
boundary, the device residual under transform skip, and the coercion of
--wpp with --slices."""
import types

import numpy as np
import pytest

import torch_port_util  # noqa: F401  (one torch thread)
from torch_port_util import make_clip, slice_params


def _encoders(parse=(), **opts):
    """(JAX encoder, port encoder) of ultrafast + zerolatency at 192x128
    with the options `parse` (through param_parse) and the attributes
    `opts` set before they open."""
    from x265_tpu.api.encoder import Encoder as JEncoder
    from x265_tpu_torch.api.encoder import Encoder as TEncoder
    pj = slice_params("x265_tpu", 192, 128, **dict(parse))
    pt = slice_params("x265_tpu_torch", 192, 128, **dict(parse))
    for p in (pj, pt):
        for k, v in opts.items():
            setattr(p, k, v)
    return JEncoder(pj), TEncoder(pt, device="cpu")


@pytest.mark.parametrize("seed,halve", [(0, False), (1, True), (2, True)])
def test_nr_offsets_equal(seed, halve):
    jenc, tenc = _encoders(nr_intra=300, nr_inter=700)
    rng = np.random.default_rng(seed)
    maxblk = (1 << 18, 1 << 16, 1 << 14, 1 << 12)
    cnt = rng.integers(0, 1 << 12, 16).astype(np.uint64)
    if halve:
        for cat in range(16):
            if rng.random() < 0.5:       # past the limit: halved first
                cnt[cat] = maxblk[cat & 3] + int(rng.integers(1, 1 << 10))
    sums = rng.integers(0, 1 << 40, (16, 1024)).astype(np.uint64)
    sums[:, 5] = 0                       # (sc + 0) // 1 for empty sums
    for e in (jenc, tenc):
        e._nr = {"sum": sums.copy(), "cnt": cnt.copy()}
    for _ in range(2):                   # the halving compounds
        want, got = jenc._nr_offsets(), tenc._nr_offsets()
        assert got.dtype == want.dtype == np.uint16
        assert np.array_equal(got, want)
        assert np.array_equal(tenc._nr["sum"], jenc._nr["sum"])
        assert np.array_equal(tenc._nr["cnt"], jenc._nr["cnt"])
    assert (got[:, 0] == 0).all() and got.any()
    if halve:
        assert (tenc._nr["cnt"] < cnt).any()


def test_nr_offsets_formula():
    """The JAX package's own formula case (test_noise_reduction.py)."""
    _, enc = _encoders(nr_intra=1000, nr_inter=0)
    enc._nr["sum"][0, 1] = 100
    enc._nr["cnt"][0] = 10
    off = enc._nr_offsets()
    assert off[0, 1] == (1000 * 10 + 50) // 101
    assert off[0, 0] == 0
    assert off[8, 1] == 0


@pytest.mark.parametrize("bd", [8, 10])
def test_luma_hist_and_hist_scenecut_equal(bd):
    from x265_tpu.api.encoder import Encoder as JEncoder
    from x265_tpu_torch.api.encoder import Encoder as TEncoder
    rng = np.random.default_rng(bd)
    top = (1 << bd) - 1
    a = rng.integers(0, top + 1, (64, 96)).astype(np.uint16)
    near = np.clip(a.astype(int) + (rng.random(a.shape) < 0.05), 0, top)
    far = (a // 3).astype(np.uint16)
    for y in (a, near.astype(np.uint16), far):
        want = JEncoder._luma_hist(y)
        got = TEncoder._luma_hist(y)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert got.shape == (max(256, (top >> 2) + 1),)
    fired = {}
    for thr in (0.03, 0.01, 0.3):
        res = []
        for cls in (JEncoder, TEncoder):
            me = types.SimpleNamespace(
                param=types.SimpleNamespace(hist_threshold=thr),
                _hist_prev=None, _luma_hist=cls._luma_hist)
            first = cls._hist_scenecut(me, a)        # nothing before it
            me._hist_prev = cls._luma_hist(a)
            res.append((first, cls._hist_scenecut(me, near),
                        cls._hist_scenecut(me, far)))
        assert res[0] == res[1]
        assert res[1][:2] == (False, False)
        fired[thr] = res[1][2]
    # the default threshold sees the cut; at 0.3 (0.35 * 10 > 2, the
    # largest normalized SAD) nothing can fire
    assert fired[0.03] and fired[0.01] and not fired[0.3]


def test_apply_intra_refresh_equal():
    """A column a P picture, swept over the 3 CTU columns of 192x128 at
    64x64 and started again; promoted 64x64 CUs in the column become 32x32
    intra CUs, those outside stay; the recovery count at each new cycle."""
    jenc, tenc = _encoders(parse={"ctu": 64}, intra_refresh=True)
    assert tenc.param.ctu_size == 64
    rng = np.random.default_rng(4)
    h8, w8 = 16, 24
    for pic in range(5):
        cu = np.full((h8, w8), 4, np.int32)
        cu[:8, :8] = 6                               # column 0, row 0
        cu[8:, 8:16] = 6                             # column 1, row 1
        cu[:8, 16:] = 6                              # column 2, row 0
        inter = rng.random((h8, w8)) < 0.9
        outs = []
        for enc in (jenc, tenc):
            dec = types.SimpleNamespace(inter8=inter.copy(),
                                        cu_log2_map=cu.copy())
            enc._ir_recovery = None      # the P access unit took it
            enc._apply_intra_refresh(dec)
            outs.append((dec.inter8, dec.cu_log2_map, enc._ir_col,
                         enc._ir_recovery))
        (ji, jc, jcol, jrec), (ti, tc, tcol, trec) = outs
        assert np.array_equal(ti, ji) and np.array_equal(tc, jc)
        assert (tcol, trec) == (jcol, jrec)
        col = pic % 3
        assert not ti[:, col * 8:col * 8 + 8].any()
        assert (tc[:, col * 8:col * 8 + 8] <= 5).all()
        outside = np.ones(w8, bool)
        outside[col * 8:col * 8 + 8] = False
        assert np.array_equal(ti[:, outside], inter[:, outside])
        assert np.array_equal(tc[:, outside], cu[:, outside])
        assert trec == (2 if col == 0 else None)
    # an intra picture's decisions (no inter map) are left alone
    dec = types.SimpleNamespace(inter8=None, cu_log2_map=cu.copy())
    tenc._apply_intra_refresh(dec)
    assert tenc._ir_col == jenc._ir_col == 2      # next: column 2


@pytest.mark.parametrize("case", ["boundary", "inside", "none", "one"])
def test_set_wpp_entry_points_equal(case):
    """Entry points count escaped bytes: a 00 00 at the end of a substream
    followed by a 00-03 byte at the start of the next puts the emulation
    prevention byte make_nal writes before that byte into the next
    substream's count; the offsets and the last substream add up to the
    escaped payload."""
    from x265_tpu.api.encoder import Encoder as JEncoder
    from x265_tpu.hevc.headers import SliceHeader as JSH
    from x265_tpu_torch.api.encoder import Encoder as TEncoder
    from x265_tpu_torch.hevc.bitstream import add_emulation_prevention
    from x265_tpu_torch.hevc.headers import SliceHeader as TSH
    rng = np.random.default_rng(9)
    parts = [bytes(rng.integers(1, 256, n, dtype=np.uint8))
             for n in (17, 9, 30, 5)]
    if case == "boundary":
        parts[0] += b"\x00\x00"
        parts[1] = b"\x01" + parts[1]
        parts[2] += b"\x00"
        parts[3] = b"\x00\x02" + parts[3]
    elif case == "inside":
        parts[1] = parts[1][:3] + b"\x00\x00\x03" + parts[1][3:]
    elif case == "one":
        parts = parts[:1]
    data = b"".join(parts)
    raw = [len(x) for x in parts]
    js, ts = JSH(), TSH()
    JEncoder._set_wpp_entry_points(js, data, raw)
    TEncoder._set_wpp_entry_points(ts, data, raw)
    assert ts.entry_point_offsets == js.entry_point_offsets
    assert len(ts.entry_point_offsets) == len(parts) - 1
    esc = add_emulation_prevention(data)
    tail = len(esc) - sum(ts.entry_point_offsets)
    if case == "boundary":
        # 00 00 | 01: the 03 goes before the 01, into substream 1; the
        # 00 | 00 02 run escapes inside the last substream
        assert ts.entry_point_offsets == [raw[0], raw[1] + 1, raw[2]]
        assert tail == raw[3] + 1 and len(esc) == len(data) + 2
    elif case == "inside":
        assert ts.entry_point_offsets == [raw[0], raw[1] + 1, raw[2]]
    else:
        assert ts.entry_point_offsets == raw[:-1] and tail == raw[-1]


def test_build_inter_pre_tskip_equal():
    """Under --tskip the device residual leaves out the 8x8 class (its 4x4
    chroma TBs choose transform skip in the native walk): the same classes
    and arrays as the JAX package's, and no 8x8 CU among has8."""
    from x265_tpu.engine.ctu_writer import FrameDecisions as JDec
    from x265_tpu.models import inter_residual as jir
    from x265_tpu_torch.models import inter_residual as tir
    from x265_tpu_torch.utils.convert import decisions_from_numpy
    from test_torch_inter_residual import _decisions
    w, h = 192, 128
    fr = make_clip(w, h, 2, seed=12)
    maps = _decisions(w, h, 6, seed=12)
    ref_pad = tuple(np.pad(np.asarray(pl).astype(np.int16),
                           80 >> (0 if i == 0 else 1), mode="edge")
                    for i, pl in enumerate(fr[0]))
    outs = []
    for tskip in (False, True):
        pj = slice_params("x265_tpu", w, h, ctu=64)
        pt = slice_params("x265_tpu_torch", w, h, ctu=64)
        pj.tskip = pt.tskip = tskip
        want = jir.build_inter_pre(
            fr[1], JDec(**{k: np.array(v) for k, v in maps.items()}),
            ([ref_pad], []), 30, pj, None, True, 0)
        got = tir.build_inter_pre(fr[1], decisions_from_numpy(**maps),
                                  ([ref_pad], []), 30, pt, None, True, 0,
                                  device="cpu")
        assert set(got) == set(want)
        for k in want:
            assert np.array_equal(got[k], np.asarray(want[k])), k
        outs.append(got)
    cu8 = (maps["cu_log2_map"] == 3) & maps["inter8"]
    assert outs[0]["has8"][cu8].all()
    assert not outs[1]["has8"][cu8].any()
    assert outs[1]["has8"][maps["inter8"] & ~cu8].all()


def test_wpp_with_slices_is_coerced_as_in_the_jax_package():
    """--wpp with --slices 2 forces --slices 1 in both packages (the
    warning names it), and the stream has one slice a picture with one
    entry point per CTU row after the first."""
    from x265_tpu.api.params import check_params as jcheck
    from x265_tpu_torch.api.encoder import Encoder
    from x265_tpu_torch.api.params import check_params as tcheck
    from x265_tpu_torch.hevc.bitstream import (split_annexb,
                                               strip_emulation_prevention)
    from x265_tpu_torch.hevc.headers import (parse_pps, parse_slice_header,
                                             parse_sps)
    ps = []
    for pkg, check in (("x265_tpu", jcheck), ("x265_tpu_torch", tcheck)):
        p = slice_params(pkg, 64, 96, wpp=1, slices=2)
        assert p.slices == 2 and p.wpp
        p = check(p)
        ps.append((p.slices, bool(p.wpp)))
    assert ps == [(1, True), (1, True)]
    enc = Encoder(slice_params("x265_tpu_torch", 64, 96, wpp=1, slices=2),
                  device="cpu")
    assert enc.param.slices == 1
    stream = enc.encode(make_clip(64, 96, 2, seed=2))
    sps = pps = None
    n = 0
    for nal in split_annexb(stream):
        t = (nal[0] >> 1) & 0x3F
        rbsp = strip_emulation_prevention(nal[2:])
        if t == 33:
            sps = parse_sps(rbsp)
        elif t == 34:
            pps = parse_pps(rbsp)
        elif t < 32:
            sh, _ = parse_slice_header(rbsp, t, sps, pps)
            assert sh.first_slice_in_pic
            assert len(sh.entry_point_offsets) == 96 // 32 - 1
            n += 1
    assert n == 2
