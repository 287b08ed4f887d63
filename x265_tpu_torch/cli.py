"""Command-line encoder (x265 CLI analog, reference source/x265.cpp).

Usage:
    python -m x265_tpu_torch.cli --input in.y4m --output out.hevc \
        --preset ultrafast --tune zerolatency --qp 30 --scenecut 0 \
        [--frames N] [--device cpu] [--no-tpu]
    python -m x265_tpu_torch.cli --input in.y4m --output out.hevc \
        --preset fast --tune zerolatency --qp 30 --scenecut 0 \
        [--no-deblock] [--no-sao] [--aq-mode N] [--aq-strength X]
        [--no-weightp]
    python -m x265_tpu_torch.cli --input in.y4m --output out.hevc \
        --preset medium --bitrate 4000 [--bframes N] [--b-adapt 0|2] \
        [--b-pyramid | --no-b-pyramid] [--frame-threads N]

    python -m x265_tpu_torch.cli --input in10.y4m --output out.hevc \
        --preset slow --scaling-list default --hdr10 --hdr10-opt \
        --master-display "G(...)B(...)R(...)WP(...)L(...)" \
        --max-cll 1000,400 [--dhdr10-info meta.json --dhdr10-opt]
    python -m x265_tpu_torch.cli --input in10.y4m --output out.hevc \
        --output-depth 8 [--dither]

    python -m x265_tpu_torch.cli --input in.y4m --output out.hevc \
        --preset medium --bitrate 4000 --pass 1 --stats run.log
    python -m x265_tpu_torch.cli ... --pass 2 --stats run.log
    python -m x265_tpu_torch.cli --input in.y4m --output out.hevc \
        --preset medium --bitrate 4000 [--zones 0,24,b=1.5/48,72,q=22] \
        [--qpfile frames.txt] [--analysis-save a.dat | --analysis-load
        a.dat [--scale-factor 2]] [--recon rec.y4m] [--recon-play CMD]

A 10-bit Y4M (C420p10) encodes as Main10; --output-depth 8 reduces it by
rounding, or with --dither by row-wise error diffusion (io/dither.py).
The presets without a tune code B frames: --bframes sets the longest run
of B pictures between two anchors, --b-adapt 2 places the anchors by the
lowres slice-type search (0: fixed mini-GOPs), --b-pyramid codes the
middle B of a run of three or more as a reference for the others, and
--frame-threads is the number of B pictures in flight. --pass 1 writes
the per-picture stats to --stats when the encode ends, and --pass 2
plans its QPs from them; --zones overrides the rate control over picture
ranges (q=QP or b=bitrate factor); --qpfile forces keyframes (I: an IDR,
K/i: a keyframe that may be a CRA) and QPs by display index;
--analysis-save writes every picture's decisions and --analysis-load
codes with them instead of analysing (--scale-factor 2: saved at half
the width and height); --recon and --recon-play receive the
reconstructed pictures in display order. --no-tpu decides the intra
CUs with the numpy analysis (engine/mode_decision.py) in place of the
device's mode bank, as the JAX package's CLI does. Every other long
option of x265 (--deblock, --sao, --aq-mode, --aq-strength, --weightp and
their --no- forms among them) goes through param_parse. Runs on the
CUDA device unless --device says otherwise. Options outside the ported
slices make the encoder raise NotImplementedError.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="x265-tpu-torch")
    ap.add_argument("--input", required=True, help="Y4M or raw YUV file")
    ap.add_argument("--output", required=True, help="Annex-B HEVC output")
    ap.add_argument("--input-res", default=None, help="WxH for raw YUV")
    ap.add_argument("--fps", default=None, help="fps for raw YUV (e.g. 25 or 30000/1001)")
    ap.add_argument("--preset", default="medium")
    ap.add_argument("--tune", default=None)
    ap.add_argument("--lossless", action="store_true")
    ap.add_argument("--qp", type=int, default=None)
    ap.add_argument("--crf", type=float, default=None)
    ap.add_argument("--bitrate", type=int, default=None, help="ABR kbps")
    ap.add_argument("--vbv-maxrate", type=int, default=0)
    ap.add_argument("--vbv-bufsize", type=int, default=0)
    ap.add_argument("--bframes", type=int, default=None)
    ap.add_argument("--keyint", type=int, default=None)
    ap.add_argument("--frames", type=int, default=0, help="max frames (0=all)")
    ap.add_argument("--recon", default=None, help="write recon Y4M")
    ap.add_argument("--recon-play", default=None, metavar="CMD",
                    help="pipe recon Y4M to a player command "
                         "(x265 --recon-y4m-exe)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--no-tpu", action="store_true",
                    help="numpy intra analysis (the reference path)")
    ap.add_argument("--dither", action="store_true",
                    help="error-diffusion dither when reducing input depth")
    ap.add_argument("--csv", default=None, help="per-frame CSV log")
    args, extra = ap.parse_known_args(argv)

    from x265_tpu_torch.api.params import param_default_preset, param_parse, RC_CQP
    from x265_tpu_torch.api.encoder import Encoder
    from x265_tpu_torch.io.y4m import open_input, VideoInfo

    w = h = 0
    if args.input_res:
        w, h = (int(v) for v in args.input_res.lower().split("x"))
    reader = open_input(args.input, w, h)
    info = reader.info

    p = param_default_preset(args.preset, args.tune)
    # any remaining --key [value] pairs route through param_parse — the
    # same long-option surface x265's CLI exposes (x265cli.h long_options)
    i = 0
    seen_opts = set()
    while i < len(extra):
        tok = extra[i]
        if not tok.startswith("--"):
            ap.error(f"unrecognized argument: {tok}")
        name = tok[2:]
        val = None
        if "=" in name:
            name, val = name.split("=", 1)
        elif (i + 1 < len(extra) and not extra[i + 1].startswith("--")):
            val = extra[i + 1]
            i += 1
        try:
            param_parse(p, name, "1" if val is None else val)
            seen_opts.add(name)
        except (KeyError, ValueError) as e:
            ap.error(f"unknown/invalid option --{name}: {e}")
        i += 1
    p.width, p.height = info.width, info.height
    if info.bit_depth > 8:
        if "output-depth" not in seen_opts:   # else keep the explicit depth
            p.bit_depth = info.bit_depth
        p.input_depth = info.bit_depth
    p.fps_num, p.fps_den = info.fps_num, info.fps_den
    if args.fps:
        param_parse(p, "fps", args.fps)
    if args.lossless:
        param_parse(p, "lossless")
    if args.qp is not None:
        p.rc_mode = RC_CQP
        p.qp = args.qp
        p.lossless = False
    if args.crf is not None:
        from x265_tpu_torch.api.params import RC_CRF
        p.rc_mode = RC_CRF
        p.crf = args.crf
    if args.bitrate is not None:
        from x265_tpu_torch.api.params import RC_ABR
        p.rc_mode = RC_ABR
        p.bitrate = args.bitrate
    p.vbv_maxrate = args.vbv_maxrate
    p.vbv_bufsize = args.vbv_bufsize
    if args.bframes is not None:
        p.bframes = args.bframes
    if args.keyint is not None:
        p.keyint = args.keyint

    p.psnr_metrics = True          # the CLI reports PSNR/SSIM like x265
    enc = Encoder(p, device=args.device)
    if args.no_tpu:
        enc.use_tpu_analysis = False

    csv = open(args.csv, "w") if args.csv else None
    csv2 = csv and p.csv_log_level >= 2
    if csv:   # x265 csvlog_frame column set (api.cpp:1284)
        cols = ("Encode Order, Type, POC, QP, Bits, "
                "Y PSNR, U PSNR, V PSNR, SSIM, Latency ms")
        if csv2:   # csv-log-level 2: per-frame analysis breakdown
            cols += (", Intra CU%, Inter CU%, Avg CU size, "
                     "CU8%, CU16%, CU32%, CU64%")
        csv.write(cols + "\n")

    # recon sinks: --recon writes a Y4M file, --recon-play pipes to a
    # player (x265 --recon-y4m-exe, source/output/reconplay.cpp). Both
    # reorder encode-order arrivals back to display order by POC.
    sinks = []
    if args.recon or args.recon_play:
        from x265_tpu_torch.io.reconplay import ReconPlay
        rinfo = VideoInfo(p.width, p.height, p.fps_num, p.fps_den,
                          bit_depth=p.bit_depth)
        if args.recon:
            sinks.append(ReconPlay("pipe:" + args.recon, rinfo))
        if args.recon_play:
            sinks.append(ReconPlay(args.recon_play, rinfo))
        enc.recon_sink = lambda idx, planes: [s.write_frame(idx, planes)
                                              for s in sinks]

    shift = info.bit_depth - p.bit_depth       # >0: reduce input depth
    if shift > 0 and args.dither:
        from x265_tpu_torch.io.dither import dither_image

    total_bytes = 0
    nframes = 0
    csv_done = 0
    t_start = time.time()
    with open(args.output, "wb") as out:
        out.write(enc.headers())
        for (y, cb, cr) in reader.frames():
            if shift > 0:
                if args.dither:
                    y, cb, cr = dither_image((y, cb, cr), info.bit_depth,
                                             p.bit_depth)
                else:
                    half = 1 << (shift - 1)
                    maxv = (1 << p.bit_depth) - 1
                    y, cb, cr = (np.minimum(
                        (v.astype(np.int32) + half) >> shift, maxv)
                        for v in (y, cb, cr))
            t0 = time.time()
            au = enc.encode_frame(y, cb, cr)
            dt = (time.time() - t0) * 1000
            out.write(au)
            total_bytes += len(au)
            if csv:
                while csv_done < len(enc.frame_stats):
                    s = enc.frame_stats[csv_done]
                    row = (f"{csv_done}, {s['type']}, {s['poc']}, "
                           f"{s['qp']}, {s['bits']}, "
                           f"{s['psnr_y']:.3f}, {s['psnr_u']:.3f}, "
                           f"{s['psnr_v']:.3f}, {s['ssim']:.5f}, "
                           f"{dt:.1f}")
                    if csv2:
                        row += (f", {s.get('cu_intra_pct', 0)}"
                                f", {s.get('cu_inter_pct', 0)}"
                                f", {s.get('avg_cu_size', 0)}"
                                f", {s.get('cu8_pct', 0)}"
                                f", {s.get('cu16_pct', 0)}"
                                f", {s.get('cu32_pct', 0)}"
                                f", {s.get('cu64_pct', 0)}")
                    csv.write(row + "\n")
                    csv_done += 1
            nframes += 1
            if args.frames and nframes >= args.frames:
                break
        tail = enc.flush()
        out.write(tail)
        total_bytes += len(tail)
    # --pass 1 writes its stats and --analysis-save closes its file here
    enc.close()
    el = time.time() - t_start
    if csv:
        csv.close()
    for s in sinks:
        s.close()
    fps = nframes / el if el > 0 else 0.0
    kbps = total_bytes * 8 * (p.fps_num / max(1, p.fps_den)) / max(1, nframes) / 1000
    st = enc.get_stats()
    extra = ""
    if st.get("frames") and "global_psnr_y" in st:
        extra = (f", Global PSNR: {st['global_psnr_y']:.3f}"
                 f", SSIM: {st['global_ssim']:.5f}")
    print(f"encoded {nframes} frames in {el:.2f}s ({fps:.2f} fps), "
          f"{kbps:.0f} kb/s{extra}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
