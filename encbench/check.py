"""What decides ``correct``: the window's stream against the plain
reference (``encbench/reference``), at the timed size.

1. ``unparsed_aus``: every access unit the window returned is read with
   the reference's header parsers; one that does not parse, that repeats
   a picture, or that names a picture never submitted counts.
2. ``recon_mismatch``: the window's first pictures in coding order, from
   its IDR, are decoded by the reference decoder and compared sample for
   sample with the port's reconstruction of them (``Encoder.recon_sink``);
   a picture that differs, or that is missing on either side, counts.
3. ``analysis_gap``: for a sample of the window's intra analyses drawn
   from the seed, the reference recomputes every block's mode costs in
   float64 from the benchmark's own source plane and reads the widest
   relative gap of the port's answer (encbench.reference.analysis).
4. ``vbv_underflows`` (cells whose configuration states a VBV): every
   access unit of the window, in coding order, through the VBV buffer
   that the configuration's maxrate, bufsize and init state; an access
   unit with more bits than the buffer holds at its removal counts.
"""
from __future__ import annotations

import sys

import numpy as np

from encbench.reference.analysis import FAST_MODES, decision_gap, mode_costs
from encbench.reference.decoder import HEVCDecoder
from encbench.reference.metrics import psnr
from encbench.stream import HeaderReader


def read_headers(header_bytes, aus, submitted):
    """[(AccessUnit, info or None)] and the count of bad access units."""
    reader = HeaderReader(header_bytes)
    out, bad, seen = [], 0, set()
    for au in aus:
        try:
            info = reader.read(au)
        except Exception as e:         # any fault of bytes from outside
            print(f"encbench: access unit of call {au.call} does not "
                  f"parse: {e!r}", file=sys.stderr, flush=True)
            info = None
        if info is None or info["display"] in seen \
                or not 0 <= info["display"] < submitted:
            bad += 1
            out.append((au, None))
            continue
        seen.add(info["display"])
        out.append((au, info))
    return out, bad


def decode_first(header_bytes, read, recon, sources, bit_depth, K):
    """Decode the first K access units; returns (mismatched pictures,
    mean luma PSNR of the decoded ones against the source)."""
    head = read[:K]
    stream = header_bytes + b"".join(au.data for au, _ in head)
    try:
        pics = {p.poc: p for p in HEVCDecoder().decode(stream)}
    except Exception as e:             # any fault of bytes from outside
        print(f"encbench: the reference decoder failed: {e!r}",
              file=sys.stderr, flush=True)
        return K, float("nan")
    mismatch, psnrs = max(0, K - len(head)), []
    for au, info in head:
        d = None if info is None else info["display"]
        pic = pics.get(d)
        rec = recon.get(d)
        if pic is None or rec is None or not all(
                np.array_equal(a, np.asarray(b)) for a, b in
                zip((pic.y, pic.cb, pic.cr), rec)):
            mismatch += 1
        if pic is not None:
            psnrs.append(psnr(sources[d], pic.y, bit_depth))
    return mismatch, (float(np.mean(psnrs)) if psnrs else float("nan"))


def kbps(aus, fps, n):
    """The bit rate of the first n access units (fewer where the window
    coded fewer), at the configuration's frame rate."""
    head = aus[:n]
    return sum(len(au.data) for au in head) * 8 * fps / max(1, len(head)) / 1e3


def vbv_underflows(sizes, maxrate_kbps, bufsize_kbit, init, fps):
    """Underflows of the VBV buffer (x265 ratecontrol.cpp updateVbv, the
    hypothetical reference decoder's coded picture buffer under a peak
    rate): it starts `init` full (a share of the buffer, or kbit where
    above 1, as --vbv-init), each access unit's bits of `sizes` (bytes)
    leave it in turn, and it fills by maxrate / fps between two, up to
    its size. Counts the access units with more bits than it held."""
    size = bufsize_kbit * 1e3
    fill = init * size if init <= 1 else init * 1e3
    per_picture = maxrate_kbps * 1e3 / fps
    under = 0
    for n in sizes:
        fill -= 8 * n
        if fill < 0:
            under += 1
            fill = 0.0
        fill = min(size, fill + per_picture)
    return under


def analysis_gap(samples, stated, device):
    """The widest gap over the sampled analyses. samples: [(source luma,
    modes, costs, S, fast, psy)]; stated: the configuration's decision
    bank ({block, fast_intra, psy_rd}). A call made with other settings
    than the configuration states is a departure: infinite gap."""
    worst = 0.0
    for src, modes, costs, S, fast, psy in samples:
        if (S, bool(fast), float(psy)) != (stated["block"],
                                           stated["fast_intra"],
                                           float(stated["psy_rd"])):
            return float("inf")
        C = mode_costs(src, S, psy, fast, device=device)
        ms = list(FAST_MODES) if fast else list(range(35))
        worst = max(worst, decision_gap(C, ms, modes, costs))
    return worst
