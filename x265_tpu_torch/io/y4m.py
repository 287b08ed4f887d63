"""Y4M / raw YUV file I/O (x265 source/input analog, no read-ahead thread —
the host feeder is synchronous for now; async prefetch arrives with the
frame pipeline)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclass
class VideoInfo:
    width: int
    height: int
    fps_num: int = 25
    fps_den: int = 1
    csp: str = "420"
    bit_depth: int = 8


class Y4MReader:
    def __init__(self, path: str):
        self.f = open(path, "rb")
        header = self.f.readline().decode("ascii", "replace").strip()
        if not header.startswith("YUV4MPEG2"):
            raise ValueError("not a Y4M file")
        self.info = VideoInfo(0, 0)
        for tok in header.split()[1:]:
            if tok[0] == "W":
                self.info.width = int(tok[1:])
            elif tok[0] == "H":
                self.info.height = int(tok[1:])
            elif tok[0] == "F":
                n, d = tok[1:].split(":")
                self.info.fps_num, self.info.fps_den = int(n), int(d)
            elif tok[0] == "C":
                c = tok[1:]
                if c.startswith("420"):
                    self.info.csp = "420"
                elif c.startswith("mono"):
                    self.info.csp = "400"
                else:
                    raise ValueError(f"unsupported colorspace {c}")
                if "p10" in c:
                    self.info.bit_depth = 10

    def frames(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        w, h = self.info.width, self.info.height
        nb = 2 if self.info.bit_depth > 8 else 1
        dt = np.uint16 if nb == 2 else np.uint8
        ysz, csz = w * h * nb, (w // 2) * (h // 2) * nb
        while True:
            line = self.f.readline()
            if not line:
                return
            if not line.startswith(b"FRAME"):
                raise ValueError("bad frame header")
            buf = self.f.read(ysz + 2 * csz)
            if len(buf) < ysz + 2 * csz:
                return
            y = np.frombuffer(buf[:ysz], dtype=dt).reshape(h, w)
            cb = np.frombuffer(buf[ysz:ysz + csz], dtype=dt).reshape(h // 2, w // 2)
            cr = np.frombuffer(buf[ysz + csz:], dtype=dt).reshape(h // 2, w // 2)
            yield y, cb, cr

    def close(self):
        self.f.close()


def write_y4m(path: str, frames, info: VideoInfo) -> None:
    with open(path, "wb") as f:
        csp = "C420p10" if info.bit_depth > 8 else "C420mpeg2"
        f.write(f"YUV4MPEG2 W{info.width} H{info.height} "
                f"F{info.fps_num}:{info.fps_den} Ip A1:1 {csp}\n"
                .encode("ascii"))
        for (y, cb, cr) in frames:
            f.write(b"FRAME\n")
            dt = np.uint16 if info.bit_depth > 8 else np.uint8
            f.write(np.ascontiguousarray(y, dtype=dt).tobytes())
            f.write(np.ascontiguousarray(cb, dtype=dt).tobytes())
            f.write(np.ascontiguousarray(cr, dtype=dt).tobytes())


class YUVReader:
    """Raw planar 4:2:0 reader (dimensions supplied externally)."""

    def __init__(self, path: str, width: int, height: int, bit_depth: int = 8):
        self.f = open(path, "rb")
        self.info = VideoInfo(width, height, bit_depth=bit_depth)

    def frames(self):
        w, h = self.info.width, self.info.height
        nb = 2 if self.info.bit_depth > 8 else 1
        dt = np.uint16 if nb == 2 else np.uint8
        ysz, csz = w * h * nb, (w // 2) * (h // 2) * nb
        while True:
            buf = self.f.read(ysz + 2 * csz)
            if len(buf) < ysz + 2 * csz:
                return
            y = np.frombuffer(buf[:ysz], dtype=dt).reshape(h, w)
            cb = np.frombuffer(buf[ysz:ysz + csz], dtype=dt).reshape(h // 2, w // 2)
            cr = np.frombuffer(buf[ysz + csz:], dtype=dt).reshape(h // 2, w // 2)
            yield y, cb, cr

    def close(self):
        self.f.close()


def open_input(path: str, width: int = 0, height: int = 0,
               bit_depth: int = 8):
    if path.endswith(".y4m"):
        return Y4MReader(path)
    if not (width and height):
        raise ValueError("raw YUV input needs --input-res")
    return YUVReader(path, width, height, bit_depth)
