"""Seeded test clips (numpy only), shared by chip_smoke.py, the tests and
the golden-stream check, so that every one of them encodes the very same
pictures.
"""
from __future__ import annotations

import hashlib

import numpy as np


def _texture(w, h, rng, m=96):
    big = rng.integers(0, 256, (h + m, w + m)).astype(np.float32)
    for _ in range(4):
        big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)
               + np.roll(big, -1, 0) + np.roll(big, -1, 1)) / 5.0
    return np.clip((big - 128.0) * 4.0 + 128.0, 0, 255)


def _frames(w, h, n, seed, gain):
    rng = np.random.default_rng(seed)
    big = _texture(w, h, rng)
    frames = []
    for i in range(n):
        dy, dx = 16 + 2 * i, 16 + 5 * i
        y = big[dy:dy + h, dx:dx + w] * gain(i) + rng.normal(0, 1.5, (h, w))
        y = np.clip(np.rint(y), 0, 255).astype(np.uint8)
        cb = (y[::2, ::2] // 2 + 64).astype(np.uint8)
        cr = (255 - y[::2, ::2] // 2).astype(np.uint8)
        frames.append((y, cb, cr))
    return frames


def make_clip(w, h, n, seed):
    """Moving band-limited texture + noise, 8-bit 4:2:0, so motion is
    non-zero and residuals are not."""
    return _frames(w, h, n, seed, lambda i: 1.0)


def make_ramp_clip(w, h, n, seed, step=0.07):
    """make_clip under a linear brightness ramp (a fade towards black:
    frame i is scaled by 1 - step*i), so that weighted prediction finds
    a weight and chroma, derived from luma, moves with it."""
    return _frames(w, h, n, seed, lambda i: 1.0 - step * i)


def _smooth_texture(w, h, rng, m=96, cell=32):
    """A texture that varies over tens of pels (a random grid every `cell`
    pels, bilinear between) with a little fine detail on top."""
    ys, xs = np.arange(h + m) / cell, np.arange(w + m) / cell
    y0, x0 = ys.astype(int), xs.astype(int)
    fy, fx = (ys - y0)[:, None], (xs - x0)[None, :]
    g = rng.normal(0.0, 1.0, ((h + m) // cell + 2, (w + m) // cell + 2))
    t = ((1 - fy) * ((1 - fx) * g[y0][:, x0] + fx * g[y0][:, x0 + 1])
         + fy * ((1 - fx) * g[y0 + 1][:, x0] + fx * g[y0 + 1][:, x0 + 1]))
    f = rng.normal(0.0, 1.0, (h + m, w + m))
    for _ in range(2):
        f = (f + np.roll(f, 1, 0) + np.roll(f, 1, 1)
             + np.roll(f, -1, 0) + np.roll(f, -1, 1)) / 5.0
    return np.clip(128.0 + 50.0 * t / t.std() + 3.0 * f / f.std(), 0, 255)


def make_cut_clip(w, h, n, seed, cut):
    """A scene cut: frames 0..cut-1 show one smooth texture, frames
    cut..n-1 an unrelated one, both moving by (5, 2) pels a frame with
    noise, 8-bit 4:2:0. The lookahead's inter cost reaches its intra cost
    at frame `cut` only, so the scenecut test fires there and nowhere
    else; the textures are smooth enough that weighted prediction finds
    no weight inside a scene (its moment fit is not motion-compensated),
    so the full-plane rd 3 passes run on every P frame."""
    scenes = [_smooth_texture(w, h, np.random.default_rng(s))
              for s in (seed, seed + 1000)]
    frames = []
    for i in range(n):
        big = scenes[int(i >= cut)]
        noise = np.random.default_rng((seed, i)).normal(0, 1.5, (h, w))
        dy, dx = 16 + 2 * i, 16 + 5 * i
        y = np.clip(np.rint(big[dy:dy + h, dx:dx + w] + noise), 0, 255)
        y = y.astype(np.uint8)
        cb = (y[::2, ::2] // 2 + 64).astype(np.uint8)
        cr = (255 - y[::2, ::2] // 2).astype(np.uint8)
        frames.append((y, cb, cr))
    return frames


def make_screen_clip(w, h, n, seed):
    """Screen content, where transform skip wins 4x4 TBs: one-pel lines
    every 8 rows and 16 columns, flat boxes, a block of seeded random
    "text" and chroma with the same sharp edges; the picture scrolls 3
    pels a frame and the text block is new in every frame."""
    rng = np.random.default_rng(seed)
    base = np.full((h, w), 40, np.uint8)
    base[::8, :] = 250
    base[:, ::16] = 10
    for _ in range(4):
        y0, x0 = rng.integers(0, h - 16), rng.integers(0, w - 32)
        base[y0:y0 + 10, x0:x0 + 30] = rng.integers(60, 200)
    frames = []
    for i in range(n):
        y = np.roll(base, i * 3, axis=1).copy()
        ty, tx = h // 2, w // 4
        y[ty:ty + 10, tx:tx + 30] = rng.integers(0, 255, (10, 30))
        cb = np.roll(base, i, axis=0)[::2, ::2].copy()
        frames.append((y, cb, np.full((h // 2, w // 2), 130, np.uint8)))
    return frames


def make_dup_cut_clip(w, h, n, seed, dup, cut):
    """make_cut_clip with two changes for --frame-dup and --hist-scenecut:
    frame `dup` repeats frame dup-1 exactly (a duplicate to drop), and
    from frame `cut` on the second scene is shown at half its contrast
    and darker (y // 2 + 16), so that the luma histogram moves at the cut
    and nowhere else."""
    frames = make_cut_clip(w, h, n, seed, cut)
    for i in range(cut, n):
        y = (frames[i][0] // 2 + 16).astype(np.uint8)
        frames[i] = (y, (y[::2, ::2] // 2 + 64).astype(np.uint8),
                     (255 - y[::2, ::2] // 2).astype(np.uint8))
    frames[dup] = tuple(pl.copy() for pl in frames[dup - 1])
    return frames


def _flat_chroma(y, cb=120):
    h, w = y.shape
    return (y, np.full((h // 2, w // 2), cb, np.uint8),
            np.full((h // 2, w // 2), 130, np.uint8))


def make_split_clip(w, h, n, seed):
    """tests/test_finalizer_split.py's clip: a sine pattern scrolling 3
    pels a frame over a copy of itself scrolling down, with noise;
    chroma from luma."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (128 + 70 * np.sin(xx / 9.0) * np.cos(yy / 7.0)).astype(int)
    out = []
    for i in range(n):
        y = np.clip(np.roll(base, 3 * i, 1) + np.roll(base // 3, i, 0)
                    + rng.integers(-4, 5, (h, w)), 0, 255)
        out.append((y.astype(np.uint8),
                    np.clip(120 + (y[::2, ::2] >> 3), 0, 255)
                    .astype(np.uint8),
                    np.full((h // 2, w // 2), 130, np.uint8)))
    return out


def make_split_clip10(w, h, n, seed):
    """make_split_clip at 10 bits: every sample times four
    (tests/test_finalizer_split.py's Main10 case)."""
    return [tuple(pl.astype(np.uint16) * 4 for pl in f)
            for f in make_split_clip(w, h, n, seed)]


def make_rdoq_clip(w, h, n, seed):
    """tests/test_rdoq.py's clip: a sine pattern scrolling 2 pels a frame
    with noise, flat chroma."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (128 + 70 * np.sin(xx / 13.0) * np.cos(yy / 11.0)).astype(int)
    return [_flat_chroma(np.clip(np.roll(base, 2 * i, 1)
                                 + rng.integers(-6, 6, (h, w)), 0, 255)
                         .astype(np.uint8)) for i in range(n)]


def make_tskip_clip(w, h, n, seed):
    """tests/test_tskip.py's screen-content-like frames: a grid of lines
    and a box scrolling 3 pels a frame, a block of new random "text" in
    every frame, chroma with the same edges."""
    rng = np.random.default_rng(seed)
    out = []
    base = np.zeros((h, w), np.uint8)
    base[::8, :] = 250
    base[:, ::16] = 10
    base[20:30, 30:60] = 128
    for i in range(n):
        y = np.roll(base, i * 3, axis=1).copy()
        y[40:50, 10:40] = rng.integers(0, 255, (10, 30))
        out.append((y, np.roll(base, i)[::2, ::2].copy(),
                    np.full((h // 2, w // 2), 130, np.uint8)))
    return out


def make_scaling_clip(w, h, n, seed):
    """tests/test_scaling_lists.py's frames: random noise panning
    (1, 2) pels a frame, flat chroma."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 16, w + 16)).astype(np.uint8)
    return [_flat_chroma(np.ascontiguousarray(
        base[i:i + h, i * 2:i * 2 + w])) for i in range(n)]


def make_nr_clip(w, h, n, seed):
    """tests/test_noise_reduction.py's clip: a still random picture under
    strong fresh noise in every frame, flat chroma."""
    rng = np.random.default_rng(seed)
    base = rng.integers(40, 210, (h, w)).astype(np.int32)
    return [_flat_chroma(np.clip(base + rng.integers(-18, 18, (h, w)),
                                 0, 255).astype(np.uint8))
            for _ in range(n)]


def make_fade_clip(w, h, n, seed):
    """tests/test_weightp.py's fade: a textured ramp and random chroma
    scaled by 1 - 0.16 i in frame i."""
    rng = np.random.default_rng(seed)
    base = (rng.integers(0, 200, (h, w)) * 0.3 +
            np.mgrid[0:h, 0:w][1] * 0.9).astype(np.float64)
    cbb = rng.integers(80, 170, (h // 2, w // 2)).astype(np.float64)
    crb = rng.integers(80, 170, (h // 2, w // 2)).astype(np.float64)
    frames = []
    for i in range(n):
        g = 1.0 - 0.16 * i
        frames.append((np.clip(base * g, 0, 255).astype(np.uint8),
                       np.clip((cbb - 128) * g + 128, 0, 255)
                       .astype(np.uint8),
                       np.clip((crb - 128) * g + 128, 0, 255)
                       .astype(np.uint8)))
    return frames


def make_tmvp_clip(w, h, n, seed):
    """tests/test_tmvp.py's pan: random noise scrolling 3 pels a frame
    with fresh noise, flat chroma."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h, w)).astype(np.int32)
    return [_flat_chroma(np.clip(np.roll(base, i * 3, axis=1)
                                 + rng.integers(-5, 5, (h, w)), 0, 255)
                         .astype(np.uint8)) for i in range(n)]


def lift10(frames, seed):
    """8-bit frames lifted to 10 bits (Main10): every sample times four
    plus two seeded low bits, uint16, so that the low bits carry noise
    that no 8-bit path would see. Takes any iterable of (y, cb, cr)."""
    rng = np.random.default_rng((seed, 10))
    return [tuple((np.asarray(pl).astype(np.uint16) << 2)
                  | rng.integers(0, 4, np.shape(pl), dtype=np.uint16)
                  for pl in f) for f in frames]


# HDR10+ (ST 2094-40) dynamic metadata: one entry a picture, as
# --dhdr10-info reads it (hevc/dhdr10.load_dhdr10_json)
DHDR10_META = {
    "BezierCurveData": {
        "Anchors": [102, 205, 307, 410, 512, 614, 717, 819, 922],
        "KneePointX": 10, "KneePointY": 25},
    "LuminanceParameters": {
        "AverageRGB": 400,
        "LuminanceDistributions": {
            "DistributionIndex": [1, 5, 10, 25, 50, 75, 90, 95, 99],
            "DistributionValues": [17, 100000, 201, 301, 405, 510,
                                   615, 720, 844]},
        "MaxScl": [17830, 16895, 14252]},
    "NumberOfWindows": 1,
    "TargetedSystemDisplayMaximumLuminance": 400,
}
MASTER_DISPLAY = ("G(13250,34500)B(7500,3000)R(34000,16000)"
                  "WP(15635,16450)L(10000000,1)")


def dhdr10_scenes(n, hold=4):
    """n per-picture entries: the targeted luminance steps every `hold`
    pictures, so that --dhdr10-opt drops the repeats between steps."""
    import json
    out = []
    for i in range(n):
        m = json.loads(json.dumps(DHDR10_META))
        m["TargetedSystemDisplayMaximumLuminance"] = 400 + 100 * (i // hold)
        out.append(m)
    return out


def write_dhdr10_json(path, n, hold=4):
    """Write dhdr10_scenes(n, hold) as a --dhdr10-info file; returns path."""
    import json
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"SceneInfo": dhdr10_scenes(n, hold)}, f)
    return str(path)


def dhdr10_expected(types, pocs, n, hold=4, opt=True):
    """The targeted luminance of the HDR10+ SEI each picture must carry,
    in encode order (None: no SEI), for dhdr10_scenes(n, hold); types and
    POCs in encode order, display index = POC (one IDR, at the start).
    With --dhdr10-opt an SEI is written on I pictures and where the
    payload differs from the last one written."""
    out, last = [], None
    for t, poc in zip(types, pocs):
        lum = 400 + 100 * (poc // hold) if poc < n else None
        if lum is None or (opt and t != "I" and lum == last):
            out.append(None)
            continue
        if opt:
            last = lum
        out.append(lum)
    return out


def stream_hdr10(stream):
    """What a stream signals for HDR10: (SPS, {SEI payload type: payload}
    of the prefix SEIs before the first picture, [targeted luminance of
    each picture's HDR10+ SEI, or None, in stream order])."""
    from x265_tpu_torch.hevc.bitstream import (split_annexb,
                                               strip_emulation_prevention)
    from x265_tpu_torch.hevc.dhdr10 import (SEI_USER_DATA_REGISTERED,
                                            parse_st2094_40)
    from x265_tpu_torch.hevc.headers import parse_sps
    from x265_tpu_torch.hevc.sei import parse_sei
    sps, first, lums, cur = None, {}, [], None
    for nal in split_annexb(stream):
        t = (nal[0] >> 1) & 0x3F
        body = strip_emulation_prevention(nal[2:])
        if t == 33:
            sps = parse_sps(body)
        elif t == 39:
            for pt, pl in parse_sei(body):
                if not lums:
                    first[pt] = pl
                if pt == SEI_USER_DATA_REGISTERED:
                    cur = parse_st2094_40(pl)[
                        "TargetedSystemDisplayMaximumLuminance"]
        elif t < 32:
            lums.append(cur)
            cur = None
    return sps, first, lums


def stream_structure(stream):
    """What a stream signals picture by picture, in stream order: a dict
    per access unit with its NAL type and slice type, its slice segments
    as (segment_address, number of entry points), the pic_struct of its
    pic_timing SEI (None: no SEI or no frame_field_info) and the
    recovery_poc_cnt of its recovery point SEI (None: none)."""
    from x265_tpu_torch.hevc.bitstream import (BitReader, split_annexb,
                                               strip_emulation_prevention)
    from x265_tpu_torch.hevc.headers import (parse_pps, parse_slice_header,
                                             parse_sps)
    from x265_tpu_torch.hevc.sei import (SEI_PIC_TIMING, SEI_RECOVERY_POINT,
                                         parse_sei)
    sps = pps = None
    pics, seis = [], {}
    for nal in split_annexb(stream):
        t = (nal[0] >> 1) & 0x3F
        body = strip_emulation_prevention(nal[2:])
        if t == 33:
            sps = parse_sps(body)
        elif t == 34:
            pps = parse_pps(body)
        elif t == 39:
            for pt, pl in parse_sei(body):
                seis[pt] = pl
        elif t < 32:
            sh, _ = parse_slice_header(body, t, sps, pps)
            if sh.first_slice_in_pic:
                ps = seis.get(SEI_PIC_TIMING)
                rp = seis.get(SEI_RECOVERY_POINT)
                pics.append({
                    "nal": t, "slice_type": sh.slice_type, "slices": [],
                    "pic_struct": (ps[0] >> 4 if ps is not None
                                   and sps.frame_field_info else None),
                    "recovery": (BitReader(rp).read_se()
                                 if rp is not None else None)})
                seis = {}
            pics[-1]["slices"].append((sh.segment_address,
                                       len(sh.entry_point_offsets or ())))
    return pics


# ---- bench.py's 1080p and 720p clips -------------------------------------
# A copy of tools/make_clips.py's clip_crowd1080, clip_pan and their
# helpers: that file
# writes Y4M through the JAX package and so imports jax, which a machine
# with only the port does not have. Same seeds, same pictures.

def _upsample_bilinear(a: np.ndarray, H: int, W: int) -> np.ndarray:
    """Bilinear resize [h,w] -> [H,W] (edge-clamped)."""
    h, w = a.shape
    ys = np.linspace(0, h - 1, H)
    xs = np.linspace(0, w - 1, W)
    y0 = np.clip(ys.astype(int), 0, h - 2)
    x0 = np.clip(xs.astype(int), 0, w - 2)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    a00 = a[y0][:, x0]
    a01 = a[y0][:, x0 + 1]
    a10 = a[y0 + 1][:, x0]
    a11 = a[y0 + 1][:, x0 + 1]
    return (a00 * (1 - fy) * (1 - fx) + a01 * (1 - fy) * fx
            + a10 * fy * (1 - fx) + a11 * fy * fx)


def value_noise(rng, H: int, W: int, octaves=(8, 16, 32, 64, 128),
                gains=(1.0, 0.6, 0.35, 0.2, 0.12)) -> np.ndarray:
    """Multi-octave value noise in [0,1] with a natural-ish spectrum."""
    out = np.zeros((H, W))
    for cells, g in zip(octaves, gains):
        grid = rng.standard_normal((cells, int(cells * W / H) + 2))
        out += g * _upsample_bilinear(grid, H, W)
    out -= out.min()
    out /= max(1e-9, out.max())
    return out


def _sample(master: np.ndarray, oy: float, ox: float,
            H: int, W: int) -> np.ndarray:
    """Bilinear subpixel crop [H,W] at float offset (oy, ox)."""
    y0 = int(np.floor(oy))
    x0 = int(np.floor(ox))
    fy = oy - y0
    fx = ox - x0
    win = master[y0:y0 + H + 1, x0:x0 + W + 1]
    return (win[:H, :W] * (1 - fy) * (1 - fx)
            + win[:H, 1:W + 1] * (1 - fy) * fx
            + win[1:H + 1, :W] * fy * (1 - fx)
            + win[1:H + 1, 1:W + 1] * fy * fx)


def _to420(yf: np.ndarray, cbf: np.ndarray, crf: np.ndarray):
    y = np.clip(yf, 0, 255).astype(np.uint8)
    cb = np.clip(cbf, 0, 255)
    cr = np.clip(crf, 0, 255)
    cb = cb.reshape(cb.shape[0] // 2, 2, cb.shape[1] // 2, 2).mean((1, 3))
    cr = cr.reshape(cr.shape[0] // 2, 2, cr.shape[1] // 2, 2).mean((1, 3))
    return y, cb.astype(np.uint8), cr.astype(np.uint8)


def clip_crowd1080(W=1920, H=1080, n=32, seed=40):
    """High-detail texture with mild pan — bench.py's 1080p fps clip
    (a generator of (y, cb, cr) frames)."""
    rng = np.random.default_rng(seed)
    MH, MW = H + 100, W + 100
    master_y = value_noise(rng, MH, MW,
                           (12, 24, 48, 96, 192),
                           (1.0, 0.6, 0.4, 0.25, 0.15)) * 210 + 22
    master_cb = value_noise(rng, MH, MW, (10, 40), (1.0, 0.5)) * 85 + 85
    master_cr = value_noise(rng, MH, MW, (16, 36), (1.0, 0.5)) * 85 + 85
    for i in range(n):
        oy, ox = 8 + 0.7 * i, 8 + 1.9 * i
        yf = _sample(master_y, oy, ox, H, W)
        cbf = _sample(master_cb, oy, ox, H, W)
        crf = _sample(master_cr, oy, ox, H, W)
        yield _to420(yf, cbf, crf)


def clip_pan(W=1280, H=720, n=50, speed=(1.3, 2.7), seed=10):
    """Textured landscape, constant subpixel pan + two moving objects —
    bench.py's 720p clip (a generator of (y, cb, cr) frames)."""
    rng = np.random.default_rng(seed)
    MH, MW = H + 200, W + 200
    master_y = value_noise(rng, MH, MW) * 200 + 28
    master_cb = value_noise(rng, MH, MW, (8, 24), (1.0, 0.4)) * 90 + 83
    master_cr = value_noise(rng, MH, MW, (6, 20), (1.0, 0.4)) * 90 + 83
    obj = value_noise(rng, 96, 128) * 160 + 60
    obj2 = value_noise(rng, 64, 64) * 160 + 48
    grain = rng.standard_normal((4, H, W)) * 1.2
    for i in range(n):
        oy = 10 + speed[0] * i
        ox = 10 + speed[1] * i
        yf = _sample(master_y, oy, ox, H, W).copy()
        cbf = _sample(master_cb, oy, ox, H, W)
        crf = _sample(master_cr, oy, ox, H, W)
        # objects move against the pan
        o1y, o1x = int(180 + 0.8 * i), int(200 + 6.0 * i) % (W - 128)
        yf[o1y:o1y + 96, o1x:o1x + 128] = obj
        o2y, o2x = int(420 + 2.5 * i) % (H - 64), int(900 - 4.0 * i) % (W - 64)
        yf[o2y:o2y + 64, o2x:o2x + 64] = obj2
        yf += grain[i % 4]
        yield _to420(yf, cbf, crf)


# ---- golden streams -------------------------------------------------------
# Small seeded encodes whose records (golden_record: the SHA-256 of the
# JAX package's stream, which the port reproduces byte for byte, its QP
# maps, picture types and QPs, ...) are kept in golden_streams.json
# beside this file. The port's tests and a machine with a GPU but no JAX
# encode the same clips and compare their records with the committed
# ones; tests/test_torch_golden_fresh.py holds the committed records
# against the JAX package, and `python -m tools.golden_record` writes them.

# the medium-preset base of the JAX package's writer tests at 96x64:
# fixed mini-GOPs, no scene cut, no AQ, cuTree or SAO, QP 30
_WRITER_OPTS = {"bframes": "0", "b-adapt": "0", "scenecut": "0",
                "aq-mode": "0", "cutree": "0", "sao": "0", "qp": "30"}
GOLDEN_CASES = {
    # name: (preset, tune, options through param_parse, clip maker, seed)
    "ultrafast_zerolatency": (
        "ultrafast", "zerolatency",
        {"qp": "30", "scenecut": "0", "ref": "1"}, "make_clip", 0),
    "fast_zerolatency_aq0": (
        "fast", "zerolatency",
        {"qp": "30", "scenecut": "0", "aq-mode": "0"}, "make_ramp_clip", 1),
    "fast_zerolatency": (
        "fast", "zerolatency",
        {"qp": "30", "scenecut": "0"}, "make_ramp_clip", 1),
    # the live encode: lookahead, scenecut (a CRA at the cut), cuTree,
    # rd 3; with and without AQ (without it, cu_qp_delta is on through
    # cuTree alone)
    "medium_zerolatency_crf": (
        "medium", "zerolatency", {"crf": "28"}, "make_cut_clip", 0),
    "medium_zerolatency_crf_aq0": (
        "medium", "zerolatency", {"crf": "28", "aq-mode": "0"},
        "make_cut_clip", 0),
    # ABR under a buffer small enough that VBV re-encodes fire
    "fast_zerolatency_abr_vbv": (
        "fast", "zerolatency",
        {"bitrate": "200", "vbv-maxrate": "200", "vbv-bufsize": "40"},
        "make_clip", 1),
    # B frames (no tune): fixed mini-GOPs of 4 (b-adapt 0, rd 2, the
    # pyramid, weightp on the P anchors); then b-adapt 2 with rd 3 and a
    # scene cut late enough for min-keyint (a CRA with RASL leading
    # pictures); then bench.py config 3's rate control scaled to the size
    "fast_crf": ("fast", None, {"crf": "28"}, "make_clip", 2),
    "medium_crf_cut": ("medium", None, {"crf": "28"}, "make_cut_clip", 2),
    "medium_abr": ("medium", None, {"bitrate": "100"}, "make_clip", 3),
    # all-intra (keyint 1: the pipelined path of Encoder.encode): bench.py
    # config 1's lossless, and CRF under medium, whose rd 3 runs the
    # intra 32x32 promotion inside the pipeline
    "ultrafast_lossless_allintra": (
        "ultrafast", None, {"lossless": "1", "keyint": "1"}, "make_clip", 4),
    "medium_allintra_crf": (
        "medium", None, {"keyint": "1", "crf": "28"}, "make_cut_clip", 5),
    # lossless with P and B pictures (transquant bypass on the device's
    # inter residual); x265's slow preset: RDOQ 2, rd 4, the explicit
    # inter RQT, the dense star search over 4 references, subme 3
    "fast_lossless": ("fast", None, {"lossless": "1"}, "make_clip", 6),
    "slow_crf": ("slow", None, {"crf": "28"}, "make_clip", 7),
    # Main10 (output-depth 10; clips lifted by lift10): weightp, deblock
    # and SAO on the low-latency path; B frames, the HME and the window
    # search with the default scaling lists; the pipelined all-intra
    # lossless path; BASELINE config 4 (slow, scaling lists, HDR10 and
    # HDR10+ metadata, hdr10-opt's luma-banded AQ)
    "main10_fast_zerolatency": (
        "fast", "zerolatency",
        {"output-depth": "10", "qp": "30", "scenecut": "0"},
        "make_ramp_clip", 8),
    "main10_medium_scaling": (
        "medium", None,
        {"output-depth": "10", "scaling-list": "default", "crf": "28"},
        "make_clip", 9),
    "main10_lossless_allintra": (
        "ultrafast", None,
        {"output-depth": "10", "lossless": "1", "keyint": "1"},
        "make_clip", 10),
    "main10_slow_hdr10": (
        "slow", None,
        {"output-depth": "10", "scaling-list": "default", "hdr10": "1",
         "hdr10-opt": "1", "master-display": MASTER_DISPLAY,
         "max-cll": "1000,400", "dhdr10-info": "<fixture>",
         "dhdr10-opt": "1", "crf": "28"},
        "make_clip", 11),
    # encodes steered from outside the encoder: two-pass ABR (the pass-1
    # stats file is the fixture, written by a pass-1 encode of the same
    # clip), a qpfile (a forced CRA, an IDR and QPs) with q= and b= zones,
    # the --scale-factor 2 chain (the fixture is the analysis saved by an
    # encode of the clip scaled to half size; 32x32 CTUs, no AQ, no
    # cuTree and fixed mini-GOPs: see ROADMAP Queue 3), ROI maps
    # (set_ctu_info on two pictures, GOLDEN_ROI)
    "medium_twopass": (
        "medium", None, {"bitrate": "100", "pass": "2",
                         "stats": "<fixture>"}, "make_clip", 12),
    "medium_qpfile_zones": (
        "medium", None, {"crf": "28", "qpfile": "<fixture>",
                         "zones": "0,2,b=1.5/8,10,q=33"}, "make_clip", 13),
    "medium_analysis_load_sf2": (
        "medium", None, {"bitrate": "100", "ctu": "32", "aq-mode": "0",
                         "cutree": "0", "b-adapt": "0", "scenecut": "0",
                         "analysis-load": "<fixture>", "scale-factor": "2"},
        "make_clip", 14),
    "medium_roi": ("medium", None, {"crf": "28"}, "make_clip", 15),
    # x265's slower preset (bframes 8, subme 4, rd 6 with RDOQ, the
    # lookahead clamped to 32 pictures) at ref 4: the port refuses its
    # ref 5 (ROADMAP Queue 3); fixed mini-GOPs, so that one run of 8 B
    # pictures is coded (b-adapt 2 places shorter runs on this clip)
    "slower_crf": ("slower", None, {"crf": "28", "ref": "4",
                                    "b-adapt": "0"}, "make_clip", 16),
    # stream structure and live robustness: WPP substreams with the
    # intra-refresh column sweep and its recovery point on the live
    # encode; multi-slice pictures (CTU-row bands; 32x32 CTUs give the
    # picture the 4 rows that 3 bands need) with B frames and SAO;
    # transform skip (SAO's second pass recomputes); noise reduction
    # across two bands, its sums carried from picture to picture; WPP on
    # the pipelined all-intra lossless path; a dropped duplicate and a
    # luma-histogram cut (the lookahead's scenecut off, so the histogram
    # decides)
    "medium_zerolatency_wpp_ir": (
        "medium", "zerolatency", {"crf": "28", "wpp": "1",
                                  "intra-refresh": "1"},
        "make_cut_clip", 18),
    "medium_slices3": ("medium", None, {"crf": "28", "slices": "3",
                                        "ctu": "32"}, "make_clip", 19),
    "medium_tskip": ("medium", None, {"crf": "28", "tskip": "1"},
                     "make_screen_clip", 20),
    "medium_nr_slices2": ("medium", None, {"crf": "28", "nr-intra": "200",
                                           "nr-inter": "500",
                                           "slices": "2"},
                          "make_clip", 21),
    "ultrafast_lossless_wpp": (
        "ultrafast", None, {"keyint": "1", "lossless": "1", "wpp": "1"},
        "make_clip", 22),
    "medium_zerolatency_dup_hist": (
        "medium", "zerolatency", {"crf": "28", "frame-dup": "1",
                                  "hist-scenecut": "1", "scenecut": "0"},
        "make_dup_cut_clip", 23),
    # the reference switches (Encoder attributes, GOLDEN_ATTRS): the
    # numpy intra analysis (--no-tpu) on the low-latency I/P encode and
    # with B frames; the Python writer on it and with SAO, deblock and
    # RDOQ; config 3's options with the native walk quantizing every TB
    # (the same stream as medium_abr's, which the digest shows)
    "ultrafast_zerolatency_notpu": (
        "ultrafast", "zerolatency",
        {"qp": "30", "scenecut": "0", "ref": "1"}, "make_clip", 24),
    "fast_crf_notpu": ("fast", None, {"crf": "28"}, "make_clip", 25),
    "ultrafast_zerolatency_py": (
        "ultrafast", "zerolatency",
        {"qp": "30", "scenecut": "0", "ref": "1"}, "make_clip", 26),
    "fast_zerolatency_rdoq_py": (
        "fast", "zerolatency",
        {"qp": "30", "scenecut": "0", "rdoq-level": "2"},
        "make_ramp_clip", 27),
    "medium_abr_cpu_residual": ("medium", None, {"bitrate": "100"},
                                "make_clip", 3),
    # a mesh of four tiles (GOLDEN_MESH, Encoder.attach_mesh): the shape
    # of the JAX package's multi-chip dry run (__graft_entry__.py), its
    # all-intra lossless encode (16x16 CTUs, one slice a band, pictures
    # through encode_frame) and its P/B encode, which the JAX package's
    # mesh codes only without the device residual (GOLDEN_ATTRS)
    "mesh4_allintra_lossless": (
        "ultrafast", None, {"lossless": "1", "keyint": "1", "ctu": "16",
                            "slices": "4"}, "make_clip", 28),
    "mesh4_medium_cpu_residual": (
        "medium", None, {"qp": "30", "bframes": "2", "rc-lookahead": "0",
                         "scenecut": "0", "slices": "4"}, "make_clip", 29),
    # the JAX package's writer and finalizer tests on their own clips
    # (176x144 or 96x64): the finalizer split's four configurations and
    # its Main10 one (tests/test_finalizer_split.py), the Python writer
    # (GOLDEN_ATTRS) under transform skip and scaling lists
    # (tests/test_tskip.py, test_scaling_lists.py), noise reduction,
    # weightp, TMVP (test_noise_reduction.py, test_weightp.py,
    # test_tmvp.py) and x265's slow preset (test_rdoq.py)
    "split_medium": ("medium", None, {"qp": "30"}, "make_split_clip", 7),
    "split_ippp": ("medium", None, {"qp": "30", "bframes": "0", "sao": "0",
                                    "aq-mode": "0", "cutree": "0"},
                   "make_split_clip", 7),
    "split_rdoq_ref2": ("medium", None, {"qp": "30", "rdoq-level": "2",
                                         "ref": "2"}, "make_split_clip", 7),
    "split_nosdh_nodeblock": ("medium", None, {"qp": "30", "signhide": "0",
                                               "deblock": "0"},
                              "make_split_clip", 7),
    "split_main10": ("medium", None, {"qp": "30", "output-depth": "10",
                                      "bframes": "2"},
                     "make_split_clip10", 7),
    "writer_tskip": ("medium", None, {**_WRITER_OPTS, "bframes": "1",
                                      "rdoq-level": "2", "tskip": "1"},
                     "make_tskip_clip", 3),
    "writer_scaling_list": ("medium", None, {
        **_WRITER_OPTS, "bframes": "1", "rdoq-level": "2",
        "scaling-list": "default"}, "make_scaling_clip", 11),
    "writer_nr": ("medium", None, {**_WRITER_OPTS, "nr-intra": "500",
                                   "nr-inter": "500"}, "make_nr_clip", 6),
    "writer_weightp": ("medium", None, {**_WRITER_OPTS, "weightp": "1"},
                       "make_fade_clip", 3),
    "writer_tmvp": ("medium", None, {**_WRITER_OPTS, "bframes": "2",
                                     "b-pyramid": "0", "tmvp": "1"},
                    "make_tmvp_clip", 4),
    "writer_slow_rdoq": ("slow", None, {"qp": "30", "bframes": "2"},
                         "make_rdoq_clip", 5),
}
# Encoder attributes a golden case sets after construction, in both
# packages (testclip.golden_stream sets them)
GOLDEN_ATTRS = {
    "ultrafast_zerolatency_notpu": {"use_tpu_analysis": False},
    "fast_crf_notpu": {"use_tpu_analysis": False},
    "ultrafast_zerolatency_py": {"use_native": False},
    "fast_zerolatency_rdoq_py": {"use_native": False},
    "medium_abr_cpu_residual": {"use_tpu_residual": False},
    "mesh4_medium_cpu_residual": {"use_tpu_residual": False},
    "writer_tskip": {"use_native": False, "use_tpu_residual": False},
    "writer_scaling_list": {"use_native": False, "use_tpu_residual": False},
    "writer_nr": {"use_native": False},
    "writer_weightp": {"use_native": False},
    "writer_tmvp": {"use_native": False},
    "writer_slow_rdoq": {"use_native": False},
}
# golden cases encoded under a mesh of this many tiles: golden_stream
# attaches the mesh its caller builds for the package (the port's
# golden_mesh; in the JAX package x265_tpu.parallel.tiles.make_tile_mesh)
GOLDEN_MESH = {"mesh4_allintra_lossless": 4, "mesh4_medium_cpu_residual": 4}
GOLDEN_SIZE = (192, 128, 5)          # width, height, frames
GOLDEN_CUT = 3                       # the scene cut of make_cut_clip cases
# cases of their own length (two mini-GOPs of B frames) and scene cut
GOLDEN_FRAMES = {"fast_crf": (11, None), "medium_crf_cut": (11, 7),
                 "medium_abr": (11, None), "slow_crf": (11, None),
                 "main10_medium_scaling": (11, None),
                 "main10_slow_hdr10": (11, None),
                 "medium_twopass": (11, None),
                 "medium_qpfile_zones": (11, None),
                 "medium_analysis_load_sf2": (11, None),
                 "slower_crf": (10, None),
                 "medium_slices3": (11, None), "medium_tskip": (11, None),
                 "medium_nr_slices2": (11, None),
                 "medium_zerolatency_dup_hist": (7, 4),
                 "fast_crf_notpu": (11, None),
                 "medium_abr_cpu_residual": (11, None),
                 "mesh4_allintra_lossless": (2, None),
                 "mesh4_medium_cpu_residual": (4, None),
                 "split_medium": (6, None), "split_ippp": (6, None),
                 "split_rdoq_ref2": (6, None),
                 "split_nosdh_nodeblock": (6, None),
                 "split_main10": (4, None), "writer_tskip": (3, None),
                 "writer_scaling_list": (3, None), "writer_nr": (4, None),
                 "writer_weightp": (3, None), "writer_tmvp": (5, None),
                 "writer_slow_rdoq": (4, None)}
GOLDEN_DUP = 2                       # the duplicate of make_dup_cut_clip
# cases of their own size: 120 lines are 7.5 rows of 16, so the bottom
# 8 lines are coded as 8x8 CUs, whose 4x4 chroma TBs transform skip can
# take (the analysis decides 16x16 blocks elsewhere)
GOLDEN_SIZES = {"medium_tskip": (192, 120),
                "mesh4_allintra_lossless": (128, 64),
                **{k: (176, 144) for k in (
                    "split_medium", "split_ippp", "split_rdoq_ref2",
                    "split_nosdh_nodeblock", "split_main10",
                    "writer_slow_rdoq")},
                **{k: (96, 64) for k in (
                    "writer_tskip", "writer_scaling_list", "writer_nr",
                    "writer_weightp", "writer_tmvp")}}
# the qpfile of medium_qpfile_zones (display index, type, QP): a B
# picture's QP, a forced keyframe (a CRA under open GOP), an IDR that
# closes the GOP, and a QP on a picture whose P type is not forced
GOLDEN_QPFILE = "# frame type qp\n2 b 38\n4 K 27\n7 I 24\n9 P 30\n"
# ROI maps of medium_roi: display index -> per-CTB QP offsets (the 2 x 3
# CTBs of 192x128 at 64x64)
GOLDEN_ROI = {"medium_roi": {1: [[6, 0, 0], [0, 0, -4]],
                             3: [[-5, -5, -5], [3, 3, 3]]}}
# a two-rendition ladder (api/ladder.AbrLadder, medium ABR) of one
# source, area ratio 2: one golden digest per rendition
GOLDEN_LADDER_SOURCE = (192, 128, 9, 17)      # width, height, frames, seed
GOLDEN_LADDER = {"ladder_192x128": (192, 128, 150),
                 "ladder_96x64": (96, 64, 50)}
# cases whose stream is Encoder.encode's (the all-intra pipelined path),
# not headers + encode_frame per picture + flush
GOLDEN_PIPELINED = ("ultrafast_lossless_allintra", "medium_allintra_crf",
                    "main10_lossless_allintra", "ultrafast_lossless_wpp")
# facts a golden entry holds beyond every case's, for the cases whose
# tests read them (golden_record): "nr", the noise-reduction sums after
# the last picture; "cutree", each cuTree propagation's offsets; "stats",
# the pass-1 stats file a two-pass case reads
GOLDEN_EXTRA = {"medium_nr_slices2": ("nr",), "fast_crf": ("cutree",),
                "medium_twopass": ("stats",)}


def golden_clip(name):
    """The case's frames: its clip maker at its size, frame count and
    seed; an 8-bit clip of an output-depth 10 case lifted by lift10."""
    w, h, n = GOLDEN_SIZE
    w, h = GOLDEN_SIZES.get(name, (w, h))
    n, cut = GOLDEN_FRAMES.get(name, (n, GOLDEN_CUT))
    maker = {f.__name__: f for f in (
        make_clip, make_ramp_clip, make_screen_clip, make_split_clip,
        make_split_clip10, make_rdoq_clip, make_tskip_clip,
        make_scaling_clip, make_nr_clip, make_fade_clip, make_tmvp_clip)}
    maker["make_cut_clip"] = lambda *a: make_cut_clip(*a, cut=cut)
    maker["make_dup_cut_clip"] = lambda *a: make_dup_cut_clip(
        *a, dup=GOLDEN_DUP, cut=cut)
    seed = GOLDEN_CASES[name][4]
    frames = maker[GOLDEN_CASES[name][3]](w, h, n, seed)
    if (GOLDEN_CASES[name][2].get("output-depth") == "10"
            and frames[0][0].dtype == np.uint8):
        frames = lift10(frames, seed)
    return frames


def golden_params(name, params_module, tmpdir=None, encoder=None):
    """The case's Param, built through the given package's api.params
    module (either package's: the option names are the same). A
    "<fixture>" value becomes a file written into tmpdir, which such a
    case needs (the stream does not depend on the path; the encoder reads
    the file when it opens): the HDR10+ file of the case's length, the
    qpfile, or what a first encode of the case writes (the pass-1 stats,
    the analysis saved at half size), which `encoder` (the package's
    Encoder as a function of a Param) runs."""
    import os
    preset, tune, opts = GOLDEN_CASES[name][:3]

    def build(opts, size=GOLDEN_SIZES.get(name, GOLDEN_SIZE[:2])):
        p = params_module.param_default_preset(preset, tune)
        for k, v in opts.items():
            params_module.param_parse(p, k, v)
        p.width, p.height = size
        return p
    fixed = dict(opts)
    for k, v in opts.items():
        if v != "<fixture>":
            continue
        if tmpdir is None or (k in ("stats", "analysis-load")
                              and encoder is None):
            raise ValueError(f"golden case {name} needs a directory and "
                             "an encoder for its fixture file")
        path = os.path.join(tmpdir, f"{name}.{k}")
        if k == "dhdr10-info":
            n = GOLDEN_FRAMES.get(name, (GOLDEN_SIZE[2],))[0]
            write_dhdr10_json(path, n)
        elif k == "qpfile":
            with open(path, "w") as f:
                f.write(GOLDEN_QPFILE)
        elif k == "stats":
            encoder(build({**opts, "pass": "1", "stats": path})).encode(
                golden_clip(name))
        elif k == "analysis-load":
            from x265_tpu_torch.io.scaler import scale_frame
            w, h = GOLDEN_SIZE[0] // 2, GOLDEN_SIZE[1] // 2
            pre = {o: x for o, x in opts.items()
                   if o not in ("analysis-load", "scale-factor")}
            encoder(build({**pre, "analysis-save": path}, (w, h))).encode(
                [scale_frame(f, h, w, device="cpu")
                 for f in golden_clip(name)])
        fixed[k] = path
    return build(fixed)


def golden_mesh(name, device):
    """The port's mesh of a GOLDEN_MESH case: its tiles all on `device`
    (parallel.tiles.make_tile_mesh(n, devices=[device] * n)); None for
    any other case."""
    if name not in GOLDEN_MESH:
        return None
    from x265_tpu_torch.parallel.tiles import make_tile_mesh
    n = GOLDEN_MESH[name]
    return make_tile_mesh(n, devices=[device] * n)


def golden_stream(enc, name, frames, mesh=None):
    """(stream, per-picture QP maps) of a golden case through the entry
    point its digest records: Encoder.encode for GOLDEN_PIPELINED, else
    headers, encode_frame per picture and flush. A recon sink already on
    the encoder still receives every picture. The case's GOLDEN_ATTRS
    are set on the encoder first, and a GOLDEN_MESH case's mesh (of the
    encoder's package, built by the caller) is attached."""
    for attr, value in GOLDEN_ATTRS.get(name, {}).items():
        setattr(enc, attr, value)
    if name in GOLDEN_MESH:
        if mesh is None or mesh.devices.size != GOLDEN_MESH[name]:
            raise ValueError(f"golden case {name} is encoded under a mesh "
                             f"of {GOLDEN_MESH[name]} tiles")
        enc.attach_mesh(mesh)
    qp_maps = []

    def note_qp():
        q = enc._last_analysis.qp_map
        qp_maps.append(None if q is None else q.astype(int).tolist())
    for idx, off in GOLDEN_ROI.get(name, {}).items():
        enc.set_ctu_info(idx, np.asarray(off, np.int32))
    if name in GOLDEN_PIPELINED:
        sink = enc.recon_sink

        def on_picture(idx, planes):
            note_qp()
            if sink is not None:
                sink(idx, planes)
        enc.recon_sink = on_picture
        return enc.encode(frames), qp_maps
    stream = enc.headers()
    for f in frames:
        stream += enc.encode_frame(*f)
        note_qp()
    return stream + enc.flush(), qp_maps


def golden_record(enc, name, frames, mesh=None, lookahead=None):
    """(stream, entry) of a golden case encoded by enc, an Encoder of
    either package, through golden_stream (mesh as there). The entry is
    what golden_streams.json keeps for the case: the stream's sha256 and
    length, the QP maps, the picture types and QPs in encode order
    (frame_stats), the display indices a scene cut was detected at, the
    pictures coded again under VBV, get_ref_frame_list() after the flush,
    and the facts GOLDEN_EXTRA names for the case; each value as the JSON
    file holds it (golden_mismatch compares two). lookahead is the
    encoder's package's engine.lookahead module, whose cutree_propagate
    a "cutree" case records (the caller passes it, as golden_ladder's
    does its ladder module)."""
    extra = GOLDEN_EXTRA.get(name, ())
    fact = {}
    if "stats" in extra:                 # pass 2 reads pass 1's file
        with open(enc.param.stats_file, "rb") as f:
            fact["stats_sha256"] = hashlib.sha256(f.read()).hexdigest()
    reencodes = [0]
    reencode_qp = enc.rc.reencode_qp

    def counted(bits):
        rq = reencode_qp(bits)
        reencodes[0] += rq is not None
        return rq
    enc.rc.reencode_qp = counted
    if "cutree" in extra:
        if lookahead is None:
            raise ValueError(f"golden case {name} records cuTree: pass the "
                             "encoder's engine.lookahead module")
        propagate = lookahead.cutree_propagate
        fact["cutree"] = []

        def recorded(records, *a, **kw):
            off = propagate(records, *a, **kw)
            fact["cutree"].append([len(records), None if off is None
                                   else array_digest(off, np.float64)])
            return off
        lookahead.cutree_propagate = recorded
    try:
        stream, qp_maps = golden_stream(enc, name, frames, mesh=mesh)
    finally:
        if "cutree" in extra:
            lookahead.cutree_propagate = propagate
    if "nr" in extra:
        fact["nr"] = {k: array_digest(enc._nr[k], np.uint64)
                      for k in ("sum", "cnt")}
    entry = {"sha256": hashlib.sha256(stream).hexdigest(),
             "bytes": len(stream), "qp_maps": qp_maps,
             "types": "".join(s["type"] for s in enc.frame_stats),
             "qps": [s["qp"] for s in enc.frame_stats],
             "scenecut_frames": sorted(enc._scenecut_frames),
             "vbv_reencodes": reencodes[0],
             "ref_frame_list": enc.get_ref_frame_list(), **fact}
    return stream, _as_json(entry)


def array_digest(a, dtype):
    """{"shape", "sha256"} of an array's samples as `dtype` (how a golden
    entry holds an array)."""
    a = np.ascontiguousarray(np.asarray(a), dtype=dtype)
    return {"shape": list(a.shape),
            "sha256": hashlib.sha256(a.tobytes()).hexdigest()}


def _as_json(x):
    """x as json.load gives it back: lists for tuples, str dict keys,
    Python numbers for numpy scalars."""
    if isinstance(x, dict):
        return {str(k): _as_json(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_as_json(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    return x


def golden_ladder(ladder_module, **kw):
    """({case: stream}, {case: entry}, ladder) of the golden ladder: the
    source clip pushed through the given package's api.ladder.AbrLadder
    (kw: its device). A rendition's entry holds its stream's sha256 and
    length, qp_maps null, and its encoder's get_stats()."""
    w, h, n, seed = GOLDEN_LADDER_SOURCE
    names = list(GOLDEN_LADDER)
    ladder = ladder_module.AbrLadder(
        w, h, [ladder_module.Rendition(*GOLDEN_LADDER[k]) for k in names],
        **kw)
    for f in make_clip(w, h, n, seed):
        ladder.push(f)
    out = ladder.finish()
    stats = ladder.stats()
    streams = {k: out[i] for i, k in enumerate(names)}
    entries = {k: _as_json({"sha256": hashlib.sha256(out[i]).hexdigest(),
                            "bytes": len(out[i]), "qp_maps": None,
                            "stats": stats[i]})
               for i, k in enumerate(names)}
    return streams, entries, ladder


def golden_digests():
    """{name: entry} from golden_streams.json (golden_record's entries,
    golden_ladder's for the renditions)."""
    import json
    import os
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "golden_streams.json")
    with open(path, encoding="utf-8") as f:
        return json.load(f)["streams"]


def golden_mismatch(name, entry):
    """The fields in which entry differs from the committed entry of
    case `name`, sorted (a field on one side only differs)."""
    gold = golden_digests()[name]
    return sorted(k for k in gold.keys() | entry.keys()
                  if gold.get(k) != entry.get(k))
