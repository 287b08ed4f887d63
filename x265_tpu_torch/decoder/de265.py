"""ctypes wrapper over system libde265 — independent conformance decoder.

Used by tests as the external arbiter (the SURVEY.md §4 'decode validation'
role that the x265 project fills with an external HEVC decoder). Returns
exact YUV planes. Gated: callers should skip if the library is absent.
"""
from __future__ import annotations

import ctypes
import ctypes.util
from typing import List, Optional, Tuple

import numpy as np

_lib = None


def available() -> bool:
    return _load() is not None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    for name in ("libde265.so.0", "libde265.so", ctypes.util.find_library("de265")):
        if not name:
            continue
        try:
            _lib = ctypes.CDLL(name)
            break
        except OSError:
            continue
    if _lib is None:
        return None
    L = _lib
    L.de265_new_decoder.restype = ctypes.c_void_p
    L.de265_push_data.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_int, ctypes.c_longlong,
                                  ctypes.c_void_p]
    L.de265_flush_data.argtypes = [ctypes.c_void_p]
    L.de265_decode.argtypes = [ctypes.c_void_p,
                               ctypes.POINTER(ctypes.c_int)]
    L.de265_get_next_picture.argtypes = [ctypes.c_void_p]
    L.de265_get_next_picture.restype = ctypes.c_void_p
    L.de265_get_image_width.argtypes = [ctypes.c_void_p, ctypes.c_int]
    L.de265_get_image_height.argtypes = [ctypes.c_void_p, ctypes.c_int]
    L.de265_get_bits_per_pixel = getattr(L, "de265_get_bits_per_pixel", None)
    if L.de265_get_bits_per_pixel is not None:
        L.de265_get_bits_per_pixel.argtypes = [ctypes.c_void_p, ctypes.c_int]
        L.de265_get_bits_per_pixel.restype = ctypes.c_int
    L.de265_get_image_plane.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_int)]
    L.de265_get_image_plane.restype = ctypes.POINTER(ctypes.c_ubyte)
    L.de265_free_decoder.argtypes = [ctypes.c_void_p]
    return _lib


def decode(stream: bytes) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Decode an Annex-B HEVC byte stream -> list of (y, cb, cr) uint8/16."""
    L = _load()
    if L is None:
        raise RuntimeError("libde265 not available")
    ctx = L.de265_new_decoder()
    if not ctx:
        raise RuntimeError("de265_new_decoder failed")
    out = []
    try:
        L.de265_push_data(ctx, stream, len(stream), 0, None)
        L.de265_flush_data(ctx)
        more = ctypes.c_int(1)
        while True:
            err = L.de265_decode(ctx, ctypes.byref(more))
            img = L.de265_get_next_picture(ctx)
            if img:
                planes = []
                for ch in range(3):
                    w = L.de265_get_image_width(img, ch)
                    h = L.de265_get_image_height(img, ch)
                    bpp = (L.de265_get_bits_per_pixel(img, ch)
                           if L.de265_get_bits_per_pixel else 8)
                    stride = ctypes.c_int(0)
                    p = L.de265_get_image_plane(img, ch, ctypes.byref(stride))
                    buf = np.ctypeslib.as_array(p, shape=(h, stride.value))
                    if bpp > 8:   # stride is in bytes; samples are uint16
                        buf16 = buf[:, :].view(np.uint16)
                        planes.append(buf16[:, :w].copy())
                    else:
                        planes.append(buf[:, :w].copy())
                out.append(tuple(planes))
            if not more.value:
                break
            if err != 0 and not img:
                break
    finally:
        L.de265_free_decoder(ctx)
    return out


def decode_file(path: str):
    with open(path, "rb") as f:
        return decode(f.read())
