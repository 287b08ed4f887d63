"""Shared helpers of the tests/test_torch_*.py files: seeded clips and
the slice's configuration, built the same way for both packages."""
import hashlib
import importlib

import numpy as np
import torch

# The port's CPU tests run small tensors, which gain nothing from torch's
# intra-op threads; under the tier-1 command's six workers the default (a
# thread a core, each waiting in an OpenMP spin) oversubscribes the
# machine several times over and slows every worker about sevenfold.
torch.set_num_threads(1)


def make_clip(w, h, n, seed=0, step=(2, 3)):
    """Moving smooth texture (non-zero motion), 8-bit 4:2:0."""
    rng = np.random.default_rng(seed)
    big = rng.integers(0, 256, (h + 64, w + 64)).astype(np.float32)
    for _ in range(3):
        big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)
               + np.roll(big, -1, 0) + np.roll(big, -1, 1)) / 5
    big = np.clip((big - 128) * 3 + 128, 0, 255)
    frames = []
    for i in range(n):
        dy, dx = 16 + step[0] * i, 16 + step[1] * i
        y = big[dy:dy + h, dx:dx + w].astype(np.uint8)
        cb = (y[::2, ::2] // 2 + 64).astype(np.uint8)
        cr = (255 - y[::2, ::2] // 2).astype(np.uint8)
        frames.append((y, cb, cr))
    return frames


def _smooth_noise(h, w, cell, rng):
    """Bilinear-upsampled random grid: aperiodic smooth texture."""
    g = rng.normal(0.0, 1.0, (h // cell + 2, w // cell + 2))
    ys, xs = np.arange(h) / cell, np.arange(w) / cell
    y0, x0 = ys.astype(int), xs.astype(int)
    fy, fx = (ys - y0)[:, None], (xs - x0)[None, :]
    return (g[y0][:, x0] * (1 - fy) * (1 - fx)
            + g[y0][:, x0 + 1] * (1 - fy) * fx
            + g[y0 + 1][:, x0] * fy * (1 - fx)
            + g[y0 + 1][:, x0 + 1] * fy * fx)


def make_hard_clip(w, h, n, seed=0):
    """Frames built so that thresholded decisions fall on both sides
    within one picture: the top half moves as one (CUs merge and
    promote), in the bottom half every 16x16 block has its own
    quarter-pel motion (they do not); contrast rises from left to right
    (skipped and coded residuals); a smooth brightness drift survives
    quantization; a few blocks per frame hold content that no reference
    has (intra candidates)."""
    rng = np.random.default_rng(seed)
    H2, W2 = h + 48, w + 48
    tex = (_smooth_noise(H2, W2, 32, rng) + 0.6 * _smooth_noise(H2, W2, 16,
                                                               rng)
           + 0.3 * _smooth_noise(H2, W2, 8, rng))
    base = 128 + 60 * tex / 1.4 * np.linspace(0.25, 1.2, W2)[None, :]
    drift = _smooth_noise(h, w, 64, np.random.default_rng(seed + 100))
    frames = []
    for i in range(n):
        cur = np.zeros((h, w), np.float64)
        for by in range(0, h, 16):
            for bx in range(0, w, 16):
                bh, bw = min(16, h - by), min(16, w - bx)
                if by < h // 2:
                    wx = wy = 0.0
                else:
                    wx = rng.integers(0, 4) / 4.0
                    wy = rng.integers(0, 4) / 4.0

                def sh(dy, dx):
                    return base[16 + by + dy + i:16 + by + dy + i + bh,
                                16 + bx + dx + 2 * i:
                                16 + bx + dx + 2 * i + bw]
                cur[by:by + bh, bx:bx + bw] = (
                    (1 - wy) * ((1 - wx) * sh(0, 0) + wx * sh(0, 1))
                    + wy * ((1 - wx) * sh(1, 0) + wx * sh(1, 1)))
        cur = cur + 3.0 * i * drift
        for _ in range(max(2, (h * w) // 8192)):
            by = int(rng.integers(0, h // 16)) * 16
            bx = int(rng.integers(0, w // 16)) * 16
            cur[by:by + 16, bx:bx + 16] = (
                np.arange(16)[:, None] * 4 + np.arange(16)[None, :] * 2
                + (17 * i) % 100 + 40)
        y = np.clip(np.rint(cur), 0, 255).astype(np.uint8)
        cb = (y[::2, ::2] // 2 + 64).astype(np.uint8)
        cr = (255 - y[::2, ::2] // 2).astype(np.uint8)
        frames.append((y, cb, cr))
    return frames


def slice_params(pkg, w, h, **extra):
    """ultrafast + zerolatency, qp 30, scenecut 0, ref 1 — through the
    named package's own param_default_preset/param_parse."""
    P = importlib.import_module(pkg + ".api.params")
    p = P.param_default_preset("ultrafast", "zerolatency")
    opts = {"qp": "30", "scenecut": "0", "ref": "1"}
    opts.update(extra)
    for k, v in opts.items():
        P.param_parse(p, k, str(v))
    p.width, p.height = w, h
    return p


# ---- golden cases (x265_tpu_torch/utils/testclip.GOLDEN_CASES) ----------

def count_reencodes(enc):
    """Count, in enc.vbv_reencodes, the VBV re-encodes the JAX package's
    encoder's rate control asks for (the port's Encoder counts its own)."""
    enc.vbv_reencodes = 0
    orig = enc.rc.reencode_qp

    def wrapped(bits):
        rq = orig(bits)
        enc.vbv_reencodes += rq is not None
        return rq
    enc.rc.reencode_qp = wrapped
    return enc


def recon_collector(enc):
    """Attach a recon sink; returns a function giving the recons in display
    order (a picture encoded again under VBV reports twice: the last
    report is the one in the stream)."""
    got = {}
    enc.recon_sink = lambda idx, planes: got.__setitem__(idx, planes)
    return lambda: [got[i] for i in sorted(got)]


def golden_encoders(name, tmpdir=None, setup=None):
    """(port encoder, port stream, recons, JAX encoder, JAX stream,
    frames) of a golden case; fails when the committed entry is not the
    JAX package's. Both encoders count their VBV re-encodes. tmpdir
    takes the case's fixture files (testclip.golden_params); each package
    writes its own (the pass-1 or analysis-save encode of a case runs on
    the package whose stream it feeds). setup, when given, is called with
    the port's encoder before it encodes (to attach spies)."""
    from x265_tpu.api import params as JP
    from x265_tpu.api.encoder import Encoder as JEncoder
    from x265_tpu_torch.api import params as TP
    from x265_tpu_torch.api.encoder import Encoder as TEncoder
    from x265_tpu_torch.utils import testclip
    frames = testclip.golden_clip(name)

    def port(p):
        return TEncoder(p, device="cpu")
    enc = port(testclip.golden_params(name, TP, tmpdir, encoder=port))
    recons = recon_collector(enc)
    if setup is not None:
        setup(enc)
    stream, qp_maps = testclip.golden_stream(enc, name, frames)
    jenc = count_reencodes(JEncoder(testclip.golden_params(
        name, JP, tmpdir, encoder=JEncoder)))
    ref, ref_qp_maps = testclip.golden_stream(jenc, name, frames)
    gold = testclip.golden_digests()[name]
    assert gold == {"sha256": hashlib.sha256(ref).hexdigest(),
                    "bytes": len(ref), "qp_maps": ref_qp_maps}, \
        f"golden entry of {name} is stale"
    assert qp_maps == ref_qp_maps
    return enc, stream, recons(), jenc, ref, frames


def golden_pair(name):
    """(port encoder, port stream, recons, JAX stream, frames) of a golden
    case; fails when the committed entry is not the JAX package's."""
    enc, stream, recons, _jenc, ref, frames = golden_encoders(name)
    return enc, stream, recons, ref, frames


def assert_decodes_to_recon(stream, recons, n):
    from x265_tpu_torch.decoder.decoder import HEVCDecoder
    pics = HEVCDecoder().decode(stream)
    assert len(pics) == n == len(recons)
    for pic, rec in zip(pics, recons):
        for a, b in zip((pic.y, pic.cb, pic.cr), rec):
            assert np.array_equal(np.asarray(a), np.asarray(b))


def assert_filtered_golden_case(name):
    """fast + zerolatency on a clip with a brightness ramp: deblock, SAO,
    weightp, three references, 64x64 CTUs; with and without AQ."""
    enc, stream, recons, ref, frames = golden_pair(name)
    assert stream == ref
    p = enc.param
    assert (p.deblock and p.sao and p.weightp and p.ref == 3
            and p.ctu_size == 64 and p.sub_me == 2 and p.rd_level == 2)
    assert "".join(s["type"] for s in enc.frame_stats) == "IPPPP"
    # every new branch was taken
    assert enc._last_weights[0] is not None       # the ramp was found
    assert enc._last_weights[1] is not None       # chroma offsets too
    sp = enc._last_sao
    assert (sp.type_y != 0).any() or (sp.type_c != 0).any()
    assert len(enc.anchors) == 3
    qmap = enc._last_analysis.qp_map
    if name == "fast_zerolatency":
        assert (qmap != enc.frame_stats[-1]["qp"]).any()
    else:
        assert (qmap == enc.frame_stats[-1]["qp"]).all()
    assert_decodes_to_recon(stream, recons, len(frames))
