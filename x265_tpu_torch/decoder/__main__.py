"""Decoder CLI: ``python -m x265_tpu_torch.decoder in.hevc [--recon out]``.

Verification front-end for the in-repo reference decoder (the TAppDecoder
analog for this framework): decodes an Annex-B HEVC elementary stream and
optionally dumps the recon as raw planar YUV or Y4M.
"""
import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="x265-tpu-dec")
    ap.add_argument("input", help="Annex-B HEVC elementary stream")
    ap.add_argument("--recon", default=None,
                    help="write decoded pictures (*.y4m or raw planar YUV)")
    args = ap.parse_args(argv)

    from x265_tpu_torch.decoder.decoder import HEVCDecoder
    with open(args.input, "rb") as f:
        stream = f.read()
    pics = HEVCDecoder().decode(stream)
    if not pics:
        print("no pictures decoded", file=sys.stderr)
        return 1
    bd = 8 if max(int(p.y.max()) for p in pics) < 256 else 10
    print(f"decoded {len(pics)} pictures "
          f"({pics[0].y.shape[1]}x{pics[0].y.shape[0]}, {bd}-bit)")
    if args.recon:
        frames = [(p.y, p.cb, p.cr) for p in pics]
        if args.recon.endswith(".y4m"):
            from x265_tpu_torch.io.y4m import VideoInfo, write_y4m
            h, w = pics[0].y.shape
            dt = np.uint8 if bd == 8 else np.uint16
            write_y4m(args.recon,
                      [tuple(pl.astype(dt) for pl in f) for f in frames],
                      VideoInfo(width=w, height=h, bit_depth=bd))
        else:
            dt = np.uint8 if bd == 8 else np.uint16
            with open(args.recon, "wb") as f:
                for (y, cb, cr) in frames:
                    for pl in (y, cb, cr):
                        f.write(pl.astype(dt).tobytes())
        print(f"recon written to {args.recon}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
